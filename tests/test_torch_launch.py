"""The port's launch layer (``repro_torch.launch.roofline`` / ``specs`` /
``dryrun`` / ``hillclimb``) against the reference's, on the CPU: the
roofline functions at the reference's v5e rates, the shapes and their
skips, the parameter tree of every architecture at full width against
``jax.eval_shape``, the per-device argument bytes on the production meshes
against the reference's placement, the dry run's counted products against
``model_work``'s figure for the port's code per family and kind, its least
work (live keys, causal pairs, routed experts, no recomputation), the
sharded count, the kernels' bounds at the shapes ``PERF.md`` §6 records,
and the command lines."""

import dataclasses
import functools
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.distributed.sharding import ShardingRules as RefRules
from repro.launch import roofline as ref_rl
from repro.launch import specs as ref_specs
from repro.models.model import Model as RefModel
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.distributed.collectives import all_gather, count_collectives
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, hillclimb, roofline as rl, specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.model import Model

V5E = dict(peak_flops=ref_rl.PEAK_FLOPS, hbm_bw=ref_rl.HBM_BW, link_bw=ref_rl.ICI_BW)
META = torch.device("meta")


# ------------------------------------------------------------------ roofline

@pytest.mark.parametrize("args", [(197e12, 100e9, 1e9), (1e12, 819e9, 500e9),
                                  (3.1e14, 2.2e12, 0.0), (0.0, 0.0, 7e10)])
def test_roofline_terms_at_v5e_rates_equal_reference(args):
    assert rl.roofline_terms(*args, **V5E) == ref_rl.roofline_terms(*args)


def test_train_flops_and_mfu_equal_reference():
    assert rl.model_flops_train(1.2e9, 4096 * 256, 3.0e15) == \
        ref_rl.model_flops_train(1.2e9, 4096 * 256, 3.0e15)
    assert rl.mfu_like(6e18, 1e16, 256) == ref_rl.mfu_like(6e18, 1e16, 256)
    assert np.isnan(rl.mfu_like(1.0, 0.0, 1)) and np.isnan(ref_rl.mfu_like(1.0, 0.0, 1))


@pytest.mark.parametrize("args,quant", [((8, 16, 1, 128, 128, 36, 16, 36), False),
                                        ((8, 16, 1, 128, 128, 30, 16, 36), True),
                                        ((2, 4, 35, 128, 128, 2048, 16, 2048), False),
                                        ((8, 5, 25, 64, 64, 20, 16, 64), True)])
def test_paged_decode_operator_equals_reference(args, quant):
    got = rl.paged_decode_operator(*args, quant=quant, **V5E)
    want = ref_rl.paged_decode_operator(*args, quant=quant)
    assert {k: got[k] for k in want} == want
    # the shared-memory model is K2's plan: its score tile within K2_TILE_BYTES
    assert 0 < got["tile_smem_bytes"] <= got["tile_smem_limit"] <= rl.SMEM_PER_BLOCK


def test_hbm_rate_by_card_name():
    assert rl.hbm_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert rl.hbm_rate("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(ValueError, match="no data-sheet memory rate"):
        rl.hbm_rate("NVIDIA A100-SXM4-80GB")


def _pages(s, nlog, bs, qpos, pages_after):
    """A table and positions as chip_smoke.py's phases build them: each
    slot's pages through the page of its position plus ``pages_after``,
    sentinels after (``_k2_inputs`` / ``_k4_inputs``, which pages is
    immaterial to the bound)."""
    nb = s * nlog + 4
    table = np.full((s, nlog), nb, np.int32)
    pos = np.zeros((s, 1), np.int32)
    used = 0
    for i in range(s):
        pos[i] = qpos[i]
        n = min(nlog, int(qpos[i]) // bs + 1 + pages_after)
        table[i, :n] = np.arange(used, used + n)
        used += n
    return table, pos


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


# PERF.md §6's bounds at 3.35 TB/s: K2 at phase 5's serve decode shape (bf16
# and int8 pools), K4 at minicpm3-4b's serve shape, K3 at olmo-1b's prefill,
# K1 on the generate prefill's [32768, 512] causal rows
@pytest.mark.parametrize("name", ["K2 bf16", "K2 int8", "K4", "K3", "K1"])
def test_moved_bounds_reproduce_the_recorded_ones(name):
    qpos = np.random.default_rng(1).integers(400, 576, size=8)
    if name.startswith("K2"):
        quant = name.endswith("int8")
        table, pos = _pages(8, 36, 16, qpos, 2)
        pool = _m(324, 16, 16, 128, dtype=torch.int8 if quant else torch.bfloat16)
        got = rl.k2_bound(_m(8, 16, 1, 128), pool, pool, table, pos, group=1, quant=quant)
        want = 0.0051 if quant else 0.0099
    elif name == "K4":
        table, pos = _pages(8, 34, 16, np.random.default_rng(1).integers(400, 544, size=8), 2)
        got = rl.k4_bound(_m(8, 40, 256), _m(8, 40, 32), _m(306, 16, 256), _m(306, 16, 32),
                          table, pos, heads=40)
        want = 0.00077
    elif name == "K3":
        x = _m(64, 512, 128)
        got = rl.k3_bound(x, x, x, causal=True)
        want = 0.0125
    else:
        got = rl.k1_bound(32768, 512, True)
        want = 0.0451
    assert got["bound_by"] == "bytes"
    # the digits PERF.md prints them with
    assert round(got["bound_ms"], 5 if name == "K4" else 4) == want, got


# -------------------------------------------------------------------- shapes

@pytest.mark.parametrize("arch", list(ARCHS))
def test_shapes_and_applicable_equal_reference(arch):
    assert list(specs.SHAPES) == list(ref_specs.SHAPES)
    assert specs.DEC_PROMPT == ref_specs.DEC_PROMPT
    cfg, ref = get_config(arch), ref_get_config(arch)
    for name, shape in specs.SHAPES.items():
        r = ref_specs.SHAPES[name]
        assert (shape.name, shape.kind, shape.seq, shape.batch, shape.max_new) == \
            (r.name, r.kind, r.seq, r.batch, r.max_new)
        assert specs.applicable(cfg, shape) == ref_specs.applicable(ref, r)


@functools.lru_cache(maxsize=None)
def _reference_tree(arch):
    """The reference's parameter shapes and logical axes at full width
    (``params_struct_of``: ``jax.eval_shape``, nothing allocated)."""
    model = RefModel(ref_get_config(arch))
    return ref_specs.params_struct_of(model), model.param_axes()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_meta_params_equal_reference_struct(arch):
    struct, _ = _reference_tree(arch)
    ours = Model(get_config(arch), device=META).init()
    want = [(p, tuple(s.shape)) for p, s in _leaves(jax.tree.map(lambda s: s, struct))]
    got = _leaves(ours)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(t.shape) for _, t in got] == [s for _, s in want]
    # the dtypes convert.params_from_numpy gives the reference's leaves
    for path, t in got:
        leaf = path[-1] if path[-1] in convert._WEIGHTS else path[0]
        assert t.dtype == (torch.bfloat16 if leaf in convert._WEIGHTS else torch.float32), path


def _ref_device_bytes(struct, axes, mesh_shape, names, rules):
    """The reference's per-device bytes: each leaf placed by
    ``sharding_for`` (``rules.spec``, indivisible mesh axes dropped)."""
    mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(mesh_shape, object))
    sizes = dict(zip(names, mesh_shape))
    total = 0
    for (path, s), (_, ax) in zip(_leaves(struct), _leaves(axes)):
        sh = ref_specs.sharding_for(tuple(s.shape), ax, mesh, rules)
        n = int(np.prod(s.shape, dtype=np.int64)) * np.dtype(s.dtype).itemsize
        for part in sh:
            for name in ((part,) if isinstance(part, str) else tuple(part or ())):
                n //= sizes[name]
        total += n
    return total


@pytest.mark.parametrize("arch", ["olmo-1b", "minicpm3-4b", "dbrx-132b", "deepseek-v2-236b",
                                  "hymba-1.5b", "whisper-base", "qwen2.5-32b"])
def test_per_device_argument_bytes_equal_reference(arch, monkeypatch):
    """The parameters (f32, as the reference's struct) and a prefill batch,
    one device's share on the single- and multi-pod meshes, as the
    reference's ``sharding_for`` places them."""
    monkeypatch.setattr(ref_specs, "NamedSharding", lambda mesh, spec: tuple(spec))
    struct, axes = _reference_tree(arch)
    cfg = get_config(arch)
    model = Model(cfg, device=META)
    params, p_axes = model.init(dtype=torch.float32), model.param_axes()
    batch = specs.prefill_batch(cfg, 32, 4096)
    ref_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.dtype(str(v.dtype)[6:]))
                 for k, v in batch.items()}
    rules = ShardingRules(tuple(cfg.sharding_overrides))
    ref_rules = RefRules(tuple(ref_get_config(arch).sharding_overrides))
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        want = _ref_device_bytes(struct, axes, mesh.dims, mesh.axis_names, ref_rules)
        assert specs.per_device_bytes(params, p_axes, mesh, rules) == want
        want = _ref_device_bytes(ref_batch, specs.batch_axes(batch), mesh.dims,
                                 mesh.axis_names, ref_rules)
        assert specs.per_device_bytes(batch, specs.batch_axes(batch), mesh, rules) == want


# ---------------------------------------------------------------- the counts

FAMILIES = ["olmo-1b", "minicpm3-4b", "dbrx-132b", "deepseek-v2-236b", "mamba2-780m",
            "hymba-1.5b", "whisper-base", "qwen2-vl-7b"]
# 64 tokens: two attention chunks and two SSD chunks of the smoke configs;
# 256 prefill rows and 64 decode rows, which the card pads no further
KINDS = {"train": specs.ShapeSpec("t", "train", 64, 1),
         "prefill": specs.ShapeSpec("p", "prefill", 64, 4),
         "decode": specs.ShapeSpec("d", "decode", 48, 64),
         "generate": specs.ShapeSpec("g", "generate", 48, 64, max_new=3)}


def _smoke_overrides(arch):
    """The smoke config at 2 layers (the hybrid at 5: global layers 0, 2
    and 4, a window layer between each), remat left to the cell."""
    sm = smoke_config(arch)
    over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm) if f.name != "remat"}
    over["n_layers"] = 5 if sm.family == "hybrid" else 2
    return over


def _work_parts(w):
    """model_work's implementation figure is its least work plus the
    excess and the recomputation it names; the least is no more."""
    assert w["impl_flops"] == w["flops"] + w["excess_flops"] + w["remat_flops"]
    assert 0 < w["flops"] <= w["impl_flops"] and w["excess_flops"] >= 0


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_flops_equal_model_work(arch, kind):
    """The products the dry run counts (FlopCounterMode on the meta device)
    equal model_work's figure for the port's code exactly; its least work
    is that less the scores of masked keys, capacity rows, the SSD chunk
    form and remat (a full cache's decode step: nothing)."""
    res = dryrun.run_cell(arch, KINDS[kind], "card", cfg_overrides=_smoke_overrides(arch))
    w = res["model_work"]
    assert res["flops_per_device"] == w["impl_flops"] > 0
    _work_parts(w)
    if kind == "decode" and arch not in ("dbrx-132b", "deepseek-v2-236b", "hymba-1.5b"):
        assert w["flops"] == w["impl_flops"]
    if kind != "train":
        assert w["remat_flops"] == 0
    assert res["bytes_per_device"] > 0
    assert res["memory"]["peak_bytes"] >= res["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("softmax,remat", [("int", "full"), ("fp", "dots")])
def test_counted_train_flops_under_softmax_and_remat(softmax, remat):
    """Training under ``int`` (Alg. 1) and under remat "dots" besides
    "full": the counted products equal model_work's figure for the port's
    code, and the least work is the same under either remat."""
    kw = dict(softmax=SoftmaxSpec(softmax), cfg_overrides=_smoke_overrides("deepseek-v2-236b"))
    res = dryrun.run_cell("deepseek-v2-236b", KINDS["train"], "card", remat=remat, **kw)
    none = dryrun.run_cell("deepseek-v2-236b", KINDS["train"], "card", remat="none", **kw)
    w = res["model_work"]
    assert res["flops_per_device"] == w["impl_flops"] > 0
    _work_parts(w)
    assert w["remat_flops"] > 0 and none["model_work"]["remat_flops"] == 0
    assert w["flops"] == none["model_work"]["flops"]
    assert res["flops_per_device"] - none["flops_per_device"] == w["remat_flops"]


def test_card_rows_count_the_card_padding():
    """A decode step of 2 rows counts its down projection at STEP_MIN_ROWS
    rows, as the card pads it; model_work counts the 2."""
    over = _smoke_overrides("olmo-1b")
    res = dryrun.run_cell("olmo-1b", specs.ShapeSpec("d", "decode", 48, 2), "card",
                          cfg_overrides=over)
    cfg = smoke_config("olmo-1b")
    pad = (64 - 2) * 2 * cfg.d_ff * cfg.d_model * over["n_layers"]
    assert res["flops_per_device"] - res["model_work"]["impl_flops"] == pad


def _smoke(arch, **over):
    return dataclasses.replace(smoke_config(arch), **dict(_smoke_overrides(arch), **over))


@pytest.mark.parametrize("keys", [[10, 20, 48, 1], 30])
def test_least_work_of_a_decode_step_reads_its_live_keys(keys):
    """A decode step's least work over a 48-position cache: QK^T and PV over
    each row's live keys, and those keys' K / V moved once beside every
    weight (the embedding: its 4 rows, or all of it where the head reads
    it), the tokens and the f32 logits;
    the port's code attends to all 48."""
    cfg = _smoke("olmo-1b")
    b, c, n = 4, 48, cfg.n_layers
    w = rl.model_work(cfg, "decode", b, c, keys=keys)
    full = rl.model_work(cfg, "decode", b, c)
    live = sum(np.broadcast_to(keys, (b,)))
    per_key = 2 * cfg.n_heads * cfg.d_head * 2 * n          # QK^T and PV, 2 FLOPs a MAC
    assert full["flops"] == full["impl_flops"] == w["impl_flops"]
    assert w["flops"] == full["flops"] - per_key * (b * c - live)
    params = Model(cfg, device=META).init(dtype=torch.bfloat16)
    embed = params["embed"]["w"].numel() if cfg.tie_embeddings else b * cfg.d_model
    weights = rl.tree_bytes({k: v for k, v in params.items() if k != "embed"}) + embed * 2
    kv = live * n * 2 * cfg.n_kv_heads * cfg.d_head * 2
    assert w["bytes"] == weights + kv + b * 8 + b * cfg.vocab * 4


def test_least_work_of_generate_prefill_and_moe():
    """generate: each step one more live key (the prompt's and the new one
    first); prefill: a causal query's keys; MoE: a row through its top-k
    experts, not every expert's capacity rows."""
    cfg = _smoke("olmo-1b")
    h, dh, n = cfg.n_heads, cfg.d_head, cfg.n_layers
    g = rl.model_work(cfg, "generate", 2, 48, max_new=3)
    pairs = 2 * ((45 + 1) + (45 + 2) + (45 + 3))
    assert g["impl_flops"] - g["flops"] == 4 * h * dh * n * (3 * 2 * 48 - pairs)
    p = rl.model_work(cfg, "prefill", 2, 16)
    assert p["impl_flops"] - p["flops"] == 4 * h * dh * n * 2 * (16 * 16 - 16 * 17 // 2)
    moe = _smoke("dbrx-132b")
    m = rl.model_work(moe, "decode", 64, 48)
    from repro_torch.models.moe import capacity
    rows = (moe.n_experts * 64 * capacity(moe, 1) - 64 * moe.moe_top_k)
    n_moe = moe.n_layers - moe.n_dense_prefix
    assert m["impl_flops"] - m["flops"] == 3 * 2 * rows * moe.d_model * moe.d_ff_expert * n_moe


@pytest.mark.parametrize("arch", ["olmo-1b", "minicpm3-4b", "hymba-1.5b"])
def test_live_keys_of_a_paged_serve_step(arch):
    """``live_keys`` of the serve step's state after each step of a paged CPU
    serve (dense, the MLA latent pool, the hybrid's global layers): a
    running slot's position and every key before it (its pages all live),
    as K2's bound reads them."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import Request

    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)), max_new=6)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, (5 + 4 * i,), dtype=np.int32),
                    max_new=6, arrival=0.0, seed=i) for i in range(3)]
    seen = []
    decode = Engine._serve_decode

    def spy(self, st, host, gens):
        out = decode(self, st, host, gens)
        seen.append((host[1].copy(), rl.live_keys(st.cache, st.buffers[0][1])))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Engine, "_serve_decode", spy)
        rep = eng.serve(reqs, ServeOptions(slots=3, paged=True, block_size=4, num_blocks=24))
    assert len(seen) == rep.steps > 0
    running = 0
    for pos, keys in seen:
        for p_, k in zip(pos, keys):
            if p_ < rep.cache_len:
                assert k == p_ + 1
                running += 1
    assert running >= 3


def test_sharded_count_is_shard_zeros_program():
    """On a 2 x 2 (data, model) mesh: half the batch a device, and shard
    0's column products and attention (half the heads) beside the whole
    wo / down / head; its two gathers a layer counted as collectives."""
    over = _smoke_overrides("olmo-1b")
    mesh = Mesh(None, ("data", "model"), (2, 2))
    shape = specs.ShapeSpec("d", "decode", 48, 4)
    one = dryrun.run_cell("olmo-1b", specs.ShapeSpec("d", "decode", 48, 2), "card",
                          cfg_overrides=over)
    two = dryrun.run_cell("olmo-1b", shape, mesh, cfg_overrides=over)
    cfg = smoke_config("olmo-1b")
    b, d, dh, f, l = 2, cfg.d_model, cfg.d_head, cfg.d_ff, 48
    h, kv, n_layers = cfg.n_heads, cfg.n_kv_heads, over["n_layers"]
    columns = n_layers * (2 * b * d * (h + 2 * kv) * dh + 4 * b * h * l * dh
                              + 2 * 2 * b * d * f)
    assert two["batch_per_device"] == 2 and two["model_shards"] == 2
    assert two["flops_per_device"] == one["flops_per_device"] - columns // 2
    gathers = two["collectives"]["all_gather"]
    assert gathers["calls"] == 2 * n_layers
    assert gathers["per_shard_bytes"] * 2 == gathers["operand_bytes"]
    assert two["memory"]["port_argument_bytes"] < one["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch,over,kind", [
    ("dbrx-132b", {"n_kv_heads": 4}, "decode"), ("deepseek-v2-236b", {}, "decode"),
    ("dbrx-132b", {"n_kv_heads": 4, "moe_impl": "a2a"}, "prefill"),
    ("deepseek-v2-236b", {"moe_impl": "expert_tp"}, "prefill"),
])
def test_sharded_moe_cell_counts_model_work(arch, over, kind):
    """An MoE serving cell on a 2 x 2 (data, model) mesh is counted: its
    products over both model shards equal model_work's figure for the
    port's code (the experts split over the shards, every expert product
    once), shard 0's are fewer, and its experts' outputs are gathered.
    MLA's down-projections from whole weights run on every shard: the
    query's ``wdq`` (and in prefill the latents' ``wdkv`` / ``wkr``)
    count once more a layer at 2 shards."""
    shape = specs.ShapeSpec("k", kind, 64 if kind == "prefill" else 48,
                            8 if kind == "prefill" else 128)
    cfg_over = dict(_smoke_overrides(arch), **over)
    res = dryrun.run_cell(arch, shape, Mesh(None, ("data", "model"), (2, 2)),
                          cfg_overrides=cfg_over)
    w = res["model_work"]
    assert res["model_shards"] == 2 and "skipped" not in res
    cfg = smoke_config(arch)
    repeated = 0
    if cfg.attention == "mla":
        rows = shape.batch // 2 * (shape.seq if kind == "prefill" else 1)
        width = cfg.q_lora_rank + (cfg.kv_lora_rank + cfg.qk_rope_dim) * (kind == "prefill")
        repeated = 2 * rows * cfg.d_model * width * cfg_over["n_layers"]
    assert res["flops_model_axis"] - repeated == w["impl_flops"] > res["flops_per_device"] > 0
    _work_parts(w)
    assert res["collectives"]["all_gather"]["calls"] > 0


def test_a2a_cell_counts_its_segment_slots():
    """``"a2a"`` on the card: the counted products equal model_work's
    figure, which counts every segment's slots (E x n x C_seg rows a
    sequence, not gather's E x C); the least work is gather's."""
    from repro_torch.models.moe import capacity, groups

    over = _smoke_overrides("dbrx-132b")
    shape = KINDS["prefill"]
    gather = dryrun.run_cell("dbrx-132b", shape, "card", cfg_overrides=over)
    a2a = dryrun.run_cell("dbrx-132b", shape, "card",
                          cfg_overrides=dict(over, moe_impl="a2a"))
    assert a2a["flops_per_device"] == a2a["model_work"]["impl_flops"]
    assert a2a["model_work"]["flops"] == gather["model_work"]["flops"]
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), **dict(over, moe_impl="a2a"))
    assert groups(cfg, shape.seq) == (16, 4) and 16 * 4 != capacity(cfg, shape.seq)
    per_row = 3 * 2 * cfg.d_model * cfg.d_ff_expert * cfg.n_experts * shape.batch
    assert (a2a["flops_per_device"] - gather["flops_per_device"]
            == per_row * (16 * 4 - capacity(cfg, shape.seq)) * cfg.n_layers)


def test_collectives_counter_changes_no_result():
    xs = [torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)]
    plain = all_gather(xs, -1)
    with count_collectives() as rec:
        counted = all_gather(xs, -1)
    assert torch.equal(plain, counted)
    assert rec == {"all_gather": {"calls": 1, "operand_bytes": 48, "per_shard_bytes": 24}}
    all_gather(xs)                                  # none open: nothing recorded
    assert rec["all_gather"]["calls"] == 1


# ------------------------------------------------------------ command lines

def test_dryrun_cli_counts_a_cell_and_names_skips(tmp_path):
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "card",
                 "--out", str(tmp_path)])
    res = json.loads((tmp_path / "card" / "olmo-1b__decode_32k.json").read_text())
    assert res["n_chips"] == 1 and res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert res["flops_per_device"] == res["model_work"]["flops"]   # 128 rows: no padding
    assert res["memory"]["argument_bytes_by_name"]["cache"] == \
        16 * 128 * 32768 * 2 * 16 * 128 * 2
    for arch, shape, item in (("dbrx-132b", "decode_32k", "item 14"),
                              ("olmo-1b", "train_4k", "item 23"),
                              ("qwen2.5-32b", "prefill_32k", "item 14"),
                              ("mamba2-780m", "decode_32k", "item 14")):
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", str(tmp_path)])
        res = json.loads((tmp_path / "single" / f"{arch}__{shape}.json").read_text())
        assert item in res["skipped"] and "flops_per_device" not in res, res


def test_hillclimb_prints_deltas_and_says_what_runs_the_same(tmp_path, monkeypatch, capsys):
    plan = [("olmo-1b", "decode_32k", "baseline", "baseline", {}),
            ("olmo-1b", "decode_32k", "bf16_params", "h", {"params_dtype": torch.bfloat16}),
            ("olmo-1b", "decode_32k", "moe_scatter_combine", "h",
             {"cfg_overrides": {"moe_impl": "scatter_combine"}}),
            ("olmo-1b", "decode_32k", "scores_bf16", "h",
             {"cfg_overrides": {"scores_dtype": "bfloat16"}}),
            ("dbrx-132b", "decode_32k", "a2a_dispatch", "h",
             {"cfg_overrides": {"moe_impl": "a2a"}, "n_layers_override": 1})]
    monkeypatch.setattr(hillclimb, "PLAN", plan)
    hillclimb.main(["--mesh", "card", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    lines = {ln.split()[0]: ln for ln in out.splitlines() if "__" in ln and "===" not in ln}
    assert "comp=" in lines["olmo-1b__decode_32k__baseline"]
    assert "serving weights are bf16 already" in lines["olmo-1b__decode_32k__bf16_params"]
    assert "gather code" in lines["olmo-1b__decode_32k__moe_scatter_combine"]
    assert "the same counts as baseline" in lines["olmo-1b__decode_32k__moe_scatter_combine"]
    assert "mem=" in lines["olmo-1b__decode_32k__scores_bf16"] and \
        "same program" not in lines["olmo-1b__decode_32k__scores_bf16"]
    assert "comp=" in lines["dbrx-132b__decode_32k__a2a_dispatch"] and \
        "REFUSED" not in lines["dbrx-132b__decode_32k__a2a_dispatch"]
    hillclimb.main(["--mesh", "single", "--cell", "dbrx", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    # dbrx-132b's 8 kv-heads do not split 16 ways: Engine.serve's refusal
    assert "SKIP" in out and "item 14" in out and "n_kv_heads=8" in out


def test_hillclimb_counts_afresh(tmp_path, monkeypatch, capsys):
    """A result already under --out (another tree's, say) is never read
    back: the run counts the variant again and overwrites it."""
    monkeypatch.setattr(hillclimb, "PLAN", [("olmo-1b", "decode_32k", "baseline", "h", {})])
    path = tmp_path / "card" / "olmo-1b__decode_32k__baseline.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"roofline": {"dominant": "stale"}}))
    hillclimb.main(["--mesh", "card", "--out", str(tmp_path)])
    assert "dom=memory" in capsys.readouterr().out
    assert json.loads(path.read_text())["roofline"]["dominant"] == "memory"
