"""Tensor-parallel serving in the port (``repro_torch.serving.sharded``,
``models/tensor_parallel.py``) against the port's single-device serve and
the reference's.

Shards are ``[torch.device("cpu")] * N``, as the reference's CI simulates N
host devices. On the CPU the sharded forward is bitwise equal to the
single-device one in bf16 (prefill, tail-prefill, decode and verify
logits and every cache byte); in f32 the logits are bitwise but for MLA at
4 shards, within 1.3 x 1.77e-6 (``F32_TOL``; deepseek-v2's 1.3 x 3.22e-6); greedy tokens are equal, and the reference's own contract makes its sharded serve equal to
its single-device serve. Covered: dense (olmo-1b) at 2 and 4 shards, GQA
(qwen2.5-32b's smoke config with ``n_kv_heads=2``), MLA (minicpm3-4b, its
latent pool split on the rank), contiguous, prefix sharing, speculative,
``kernel="pallas"`` (K2's and K4's plain versions on the CPU), chunked
prefill with preemption, the int8 pool and M-RoPE; the MoE family
(dbrx-132b with 4 kv-heads, deepseek-v2-236b) at 2 and 4 shards, with
experts split over the shards, under ``"gather"``, ``"a2a"`` and
``"expert_tp"`` and with expert counts the shards do not divide, its leaves
placed where the reference's ``shard_params`` places them. The host-side half
(validation messages, ``pool_report``, the cache axes, placement) is held
equal to the reference's; qwen2.5-32b's config and its smoke model's
prefill and greedy decode against the reference's through ``convert``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget
from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models import kv_cache as jkv
from repro.models.model import Model as JModel
from repro.serving import sharded as jsh
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro.serving.scheduler import random_trace, shared_prefix_trace
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.convert import cast_weights, params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.distributed.collectives import Shards
from repro_torch.distributed.sharding import ShardingRules, serving_rules
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import kv_cache
from repro_torch.models.model import Model
from repro_torch.serving import sharded
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(n):
    return make_serving_mesh(n, devices=[CPU] * n)


_ENGINES = {}


def _engine(arch, **over):
    """The port's smoke engine (f32, int_pallas) on the reference's
    ``init(PRNGKey(0))`` parameters, and the reference's engine."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _ENGINES:
        jcfg = dataclasses.replace(jsmoke(arch, softmax=JSpec("int_pallas")), **over)
        tcfg = dataclasses.replace(smoke_config(arch, softmax=SoftmaxSpec("int_pallas")),
                                   **over)
        jm = JModel(jcfg, dtype=jnp.float32)
        jp = jm.init_split(jax.random.PRNGKey(0))[0]
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _ENGINES[key] = (JEngine(jm, jp, max_new=6),
                         Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp,
                                max_new=6))
    return _ENGINES[key]


def _trace(vocab, n=5, seed=0):
    """tests/test_sharded_serving.py's trace."""
    return random_trace(n, vocab, seed=seed, prompt_lens=(4, 8), max_new_range=(4, 6),
                        arrival_spacing=1.0)


def _tokens(rep):
    return [r.tokens.tolist() for r in rep.results]


# ------------------------------------------------------- the host-side half


@pytest.mark.parametrize("arch,over,n", [
    ("olmo-1b", {}, 3), ("olmo-1b", {}, 8), ("qwen2.5-32b", {}, 2),
    ("qwen2.5-32b", {"n_kv_heads": 2}, 4), ("minicpm3-4b", {"kv_lora_rank": 66}, 4),
    ("mamba2-780m", {}, 2), ("hymba-1.5b", {}, 2), ("whisper-base", {}, 2),
    ("dbrx-132b", {}, 2), ("deepseek-v2-236b", {}, 8),
])
def test_validate_serving_shards_messages_equal_reference(arch, over, n):
    with pytest.raises(ValueError) as want:
        jsh.validate_serving_shards(dataclasses.replace(jsmoke(arch), **over), n)
    with pytest.raises(ValueError) as got:
        sharded.validate_serving_shards(dataclasses.replace(smoke_config(arch), **over), n)
    assert str(got.value) == str(want.value)
    for ok in (0, 1):
        sharded.validate_serving_shards(smoke_config(arch), ok)


def test_validate_serving_mesh_names_the_model_axis():
    """The reference's message, with the port's module and recipe in place
    of ``repro.launch.mesh`` and XLA_FLAGS; a mesh that splits the heads
    unevenly raises ``validate_serving_shards``'s message."""
    cfg = smoke_config("olmo-1b")
    with pytest.raises(ValueError) as want:
        jsh.validate_serving_mesh(jsmoke("olmo-1b"), jax.sharding.Mesh(
            np.array(jax.devices()[:1]), ("data",)))
    from repro_torch.launch.mesh import Mesh, SHARDS_ON_ONE_DEVICE
    with pytest.raises(ValueError) as got:
        sharded.validate_serving_mesh(cfg, Mesh(np.array([CPU], dtype=object), ("data",)))
    head = str(want.value).split(" — build one with ")[0]
    assert str(got.value).startswith(head + " — build one with ")
    assert str(got.value).endswith(
        "repro_torch.launch.mesh.make_serving_mesh(shards); " + SHARDS_ON_ONE_DEVICE)
    with pytest.raises(ValueError, match="n_heads=4 is not divisible by shards=3"):
        sharded.validate_serving_mesh(cfg, _mesh(3))


def test_make_serving_mesh_wants_devices_named():
    """No shard lands on a shared device unasked: N > the visible devices
    raises, naming the recipe."""
    from repro_torch.launch.mesh import SHARDS_ON_ONE_DEVICE
    with pytest.raises(ValueError) as e:
        make_serving_mesh(2, devices=[CPU])
    assert str(e.value) == ("serving mesh wants 2 shards but only 1 device(s) are "
                            f"visible; {SHARDS_ON_ONE_DEVICE}")
    with pytest.raises(ValueError, match="shards must be >= 1"):
        make_serving_mesh(0, devices=[CPU])
    mesh = _mesh(4)
    assert mesh.shape == {"model": 4} and mesh.axis_names == ("model",)
    assert mesh == _mesh(4) and hash(mesh) == hash(_mesh(4)) and mesh != _mesh(2)


@pytest.mark.parametrize("arch,over,n", [
    ("olmo-1b", {}, 4), ("qwen2.5-32b", {"n_kv_heads": 2}, 2),
    ("llama2-7b", {"kv_quant": True}, 4), ("minicpm3-4b", {}, 2), ("minicpm3-4b", {}, 4),
    ("dbrx-132b", {"n_kv_heads": 4}, 4), ("deepseek-v2-236b", {}, 2),
])
def test_pool_report_and_cache_axes_equal_reference(arch, over, n):
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    tcfg = dataclasses.replace(smoke_config(arch), **over)
    geom = (4, 32, 16, 20)
    assert sharded.pool_report(tcfg, *geom, n) == jsh.pool_report(jcfg, *geom, n)
    assert kv_cache.paged_cache_axes(tcfg, *geom) == jkv.paged_cache_axes(jcfg, *geom)
    assert kv_cache.serve_cache_axes(tcfg, 4, 32) == jkv.serve_cache_axes(jcfg, 4, 32)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch,over", [("qwen2.5-32b", {"n_kv_heads": 2, "kv_quant": True}),
                                       ("minicpm3-4b", {})])
def test_place_cache_splits_pools_by_serving_axes(arch, over, paged):
    """``place_cache`` of a filled cache gives each shard its kv-heads (MLA:
    its rank slice) and whole tables, each its own storage; the engine's
    per-shard step cache is ``place_cache`` of the zeroed cache (sentinel
    tables), and a shard's paged bytes are ``pool_report``'s
    ``per_device_bytes``."""
    cfg = dataclasses.replace(smoke_config(arch), **over)
    n, rules, mesh = 2, serving_rules(ShardingRules(cfg.sharding_overrides)), _mesh(2)
    geom = (4, 32, 16, 20) if paged else (4, 32)
    if paged:
        full = kv_cache.paged_cache_zeros(cfg, *geom, device="cpu")
        axes = kv_cache.paged_cache_axes(cfg, *geom)
    else:
        full = kv_cache.cache_zeros(cfg, *geom, device="cpu")
        axes = kv_cache.serve_cache_axes(cfg, *geom)
    zeros = kv_cache.tree_map(torch.clone, full)
    g = torch.Generator().manual_seed(0)
    for leaf in kv_cache.tree_leaves(full):
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g).to(leaf.dtype))
    placed = sharded.place_cache(full, axes, rules, mesh)
    eng = Engine(Model(cfg, device="cpu"), None)
    own = eng._step_cache(cfg, *geom[:2], geom[2:] or None, mesh=mesh)
    assert isinstance(own, Shards) and len(own) == n
    for i, (shard, mine) in enumerate(zip(placed, own)):
        for k, leaf in shard.items():
            dim = sharded.model_dim(full[k].shape, axes[k], rules, mesh)
            want = full[k] if dim is None else full[k].chunk(n, dim)[i]
            assert torch.equal(leaf, want) and leaf.data_ptr() != full[k].data_ptr()
            assert mine[k].is_contiguous()
            assert torch.equal(mine[k], zeros[k] if dim is None else zeros[k].chunk(n, dim)[i])
        if paged:
            nbytes = sum(t.numel() * t.element_size() for t in shard.values())
            assert nbytes == sharded.pool_report(cfg, *geom, n)["per_device_bytes"]
    # every shard's leaves are its own storage
    ptrs = [t.data_ptr() for t in kv_cache.tree_leaves(placed)]
    assert len(set(ptrs)) == len(ptrs)


def test_shard_params_slices_columns_and_shares_the_rest():
    """Column-parallel weights are views of the engine's (no copy on one
    device); row-parallel weights, norms and the tied embedding are the
    engine's own tensors."""
    _, eng = _engine("qwen2.5-32b", n_kv_heads=2)
    m = eng.model
    rules = serving_rules(ShardingRules(m.cfg.sharding_overrides))
    sp = sharded.shard_params(eng.params, m.param_axes(), rules, _mesh(2))
    full, lay = eng.params["stack"]["layers"], [t["stack"]["layers"] for t in sp]
    assert sp.devices == [CPU, CPU]
    for i, l in enumerate(lay):
        for name, dim in (("wq", 2), ("wk", 2), ("wv", 2)):
            w = full["attn"][name]["w"]
            assert torch.equal(l["attn"][name]["w"], w.chunk(2, dim)[i])
            assert l["attn"][name]["w"].untyped_storage().data_ptr() == \
                w.untyped_storage().data_ptr()
            assert torch.equal(l["attn"][name]["b"], full["attn"][name]["b"].chunk(2, 1)[i])
        for name in ("gate", "up"):
            assert torch.equal(l["ffn"][name]["w"], full["ffn"][name]["w"].chunk(2, 2)[i])
        assert l["attn"]["wo"]["w"] is full["attn"]["wo"]["w"]
        assert l["ffn"]["down"]["w"] is full["ffn"]["down"]["w"]
        assert l["norm1"]["scale"] is full["norm1"]["scale"]
        assert sp[i]["embed"]["w"] is eng.params["embed"]["w"]
        assert torch.equal(sp[i]["head"]["w"], eng.params["head"]["w"].chunk(2, 1)[i])


@pytest.mark.parametrize("arch,over,n", [
    ("dbrx-132b", {"n_kv_heads": 4}, 2), ("dbrx-132b", {"n_kv_heads": 4}, 4),
    ("deepseek-v2-236b", {}, 2), ("deepseek-v2-236b", {"moe_impl": "expert_tp"}, 4),
    ("dbrx-132b", {"n_kv_heads": 4, "n_experts": 6}, 4),
])
def test_moe_placement_equals_reference_axes(arch, over, n, monkeypatch):
    """Every MoE leaf split where the reference's ``shard_params`` places
    it under ``serving_rules``: the router and the expert gate / up by
    ``experts`` (EP) or every expert's hidden by ``mlp`` (``expert_tp``),
    the shared experts by ``mlp``; row-parallel ``down`` whole; an expert
    count the shards do not divide whole, as ``sharding_for`` drops the
    axis. Each split leaf is its chunk of the whole weight; the reference
    accepts every such shard count (``validate_serving_shards``)."""
    from repro.distributed.sharding import ShardingRules as JRules, serving_rules as jrules
    from repro.launch import specs as jspecs
    import types

    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: tuple(spec))
    jcfg = dataclasses.replace(jsmoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jsh.validate_serving_shards(jcfg, n)
    sharded.validate_serving_shards(cfg, n)
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator("cpu").manual_seed(0))
    axes = m.param_axes()
    assert axes == JModel(jcfg).param_axes()
    sp = sharded.shard_params(p, axes, serving_rules(ShardingRules(cfg.sharding_overrides)),
                              _mesh(n))
    ref_rules = jrules(JRules(jcfg.sharding_overrides))
    mesh = types.SimpleNamespace(axis_names=("model",), devices=np.empty((n,), object))
    split = 0

    def walk(w, ax, path):
        nonlocal split
        if isinstance(w, dict):
            for k in w:
                walk(w[k], ax[k], path + (k,))
            return
        if jsh._row_parallel(ax, ref_rules):
            ax = (None,) * len(ax)
        spec = jspecs.sharding_for(tuple(w.shape), ax, mesh, ref_rules)
        dims = [i for i, part in enumerate(spec) if part == "model"]
        for i, t in enumerate(sp):
            got = t["stack"]["layers"]["ffn"]
            for k in path:
                got = got[k]
            if dims:
                assert torch.equal(got, w.chunk(n, dims[0])[i]), path
                split += 1
            else:
                assert got is w, path

    walk(p["stack"]["layers"]["ffn"], axes["stack"]["layers"]["ffn"], ())
    uneven = cfg.n_experts % n
    assert split == (0 if uneven else n * (5 if cfg.n_shared_experts else 3))


def test_qwen2_5_32b_config_matches_reference():
    """The last reference architecture: every field the reference's, 32.76 B
    parameters, QKV biases and an untied head."""
    want = dataclasses.asdict(jget("qwen2.5-32b"))
    got = dataclasses.asdict(get_config("qwen2.5-32b"))
    for k in ("softmax",):
        want.pop(k), got.pop(k)
    assert got == want
    cfg = get_config("qwen2.5-32b")
    assert cfg.qkv_bias and not cfg.tie_embeddings
    assert abs(cfg.param_count() / 1e9 - 32.76) < 0.01


def test_qwen2_5_32b_smoke_prefill_and_decode_match_reference():
    """The smoke model through ``convert`` (its ``"b"`` biases drawn
    non-zero on both sides): prefill logits and 6 greedy decode steps."""
    jeng, eng = _engine("qwen2.5-32b")
    rng = np.random.default_rng(0)
    jp = jax.tree.map(np.asarray, jeng.params)

    def bias(tree):
        for name in ("wq", "wk", "wv"):
            b = tree["stack"]["layers"]["attn"][name]["b"]
            tree["stack"]["layers"]["attn"][name]["b"] = rng.normal(
                0, 0.1, b.shape).astype(np.float32)
        return tree

    jp = bias(jp)
    assert "head" in jp
    tcfg, jm = eng.model.cfg, jeng.model
    tp = params_from_numpy(jp, tcfg, "cpu", torch.float32)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 10), dtype=np.int32)
    jl, _ = jm.prefill(jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(prompts)}, 16)
    tl, _ = eng.model.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-4)
    jres = JEngine(jm, jax.tree.map(jnp.asarray, jp), max_new=6).generate(
        prompts, mode="eager")
    tres = Engine(eng.model, tp, max_new=6).generate(prompts, mode="eager")
    assert np.array_equal(tres.tokens, np.asarray(jres.tokens))


# ------------------------------------------------ the shard-local forward

# f32 on the CPU: every case bitwise but MLA at 4 shards, whose decode
# logits read 1.77e-6 off the single-device step (the one-head score einsum
# [B, 1, 1, r] x [B, L, r] sums in another order than the four-head one);
# the limit is 1.3x that reading. bf16, the serving dtype, is bitwise
# everywhere, and so are the shards' tokens in both
F32_TOL = 1.3 * 1.77e-6
# deepseek-v2-236b's smoke model (MLA at 4 heads, as minicpm3-4b's) at 4
# shards in f32: the same one-head score einsum, whose decode logits read
# 3.22e-6 off the single-device step (2.74e-6 under "a2a"); its 2-shard
# cases and every bf16 case are bitwise. The limit is 1.3x the reading
MLA_MOE_F32_TOL = 1.3 * 3.22e-6


def _same(a, b, dtype, tol=F32_TOL):
    if dtype == torch.bfloat16:
        assert torch.equal(a, b)
    else:
        assert (a - b).abs().max().item() <= tol


# the MoE smoke configs: dbrx-132b's keeps 1 kv-head of its 4 heads (8 of
# 48), which no shard count splits, so it takes 4 (GQA group 1; the
# kv-head split is the dense family's, covered above at group 2)
DBRX = {"n_kv_heads": 4}
MOE_FORWARD = [
    ("dbrx-132b", DBRX, 2), ("dbrx-132b", DBRX, 4), ("deepseek-v2-236b", {}, 2),
    ("deepseek-v2-236b", {}, 4),
    ("dbrx-132b", dict(DBRX, moe_impl="a2a", moe_a2a_segments=4), 2),
    ("deepseek-v2-236b", {"moe_impl": "a2a", "moe_a2a_segments": 4}, 4),
    ("dbrx-132b", dict(DBRX, moe_impl="expert_tp"), 4),
    ("deepseek-v2-236b", {"moe_impl": "expert_tp"}, 2),
    ("dbrx-132b", dict(DBRX, n_experts=6), 4), ("deepseek-v2-236b", {"n_experts": 5}, 2),
]


@pytest.mark.parametrize("arch,over,n", [
    ("olmo-1b", {}, 4), ("qwen2.5-32b", {"n_kv_heads": 2}, 2), ("minicpm3-4b", {}, 2),
    ("minicpm3-4b", {}, 4), ("llama2-7b", {"kv_quant": True}, 4),
] + MOE_FORWARD)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_forward_is_bitwise(arch, over, n, dtype):
    """Prefill, tail prefill, a paged decode step and a verify block over
    the shards give the single-device logits and cache bytes exactly (in
    f32, MLA at 4 shards within its limit above). The MoE cases: both
    families at 2 and 4 shards, under "a2a" (4 segments: the 12-token
    prefill and the 4-token tail take the segment path, the decode step
    and the 3-token block the fallback) and "expert_tp", and expert counts
    the shard count does not divide (blocks of 2, 2, 2, 0 and 3, 2)."""
    _, eng = _engine(arch, **over)
    tol = MLA_MOE_F32_TOL if arch == "deepseek-v2-236b" and n == 4 else F32_TOL
    same = functools.partial(_same, dtype=dtype, tol=tol)
    m, p, cfg = eng.model, eng.params, eng.model.cfg
    if dtype == torch.bfloat16:
        m = Model(cfg, dtype=dtype, device="cpu")
        p = cast_weights(p, dtype)
    rules = serving_rules(ShardingRules(cfg.sharding_overrides))
    mesh = _mesh(n)
    sp = sharded.shard_params(p, m.param_axes(), rules, mesh)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (1, 12)))
    l1, c1 = m.prefill(p, {"tokens": toks}, 32)
    l2, c2 = m.prefill(sp, {"tokens": toks}, 32)
    same(l1, l2)
    geom = (2, 32, 4, 24)
    pc = kv_cache.paged_cache_zeros(cfg, *geom, device="cpu")
    axes = kv_cache.paged_cache_axes(cfg, *geom)
    pcs = sharded.place_cache(pc, axes, rules, mesh)
    row = np.arange(8, dtype=np.int32)
    for cache, vals in ((pc, c1), (pcs, c2)):
        kv_cache.paged_scatter(cache, vals, 0, row, np.arange(12) // 4, np.arange(12) % 4,
                               0, 12)
    t1, _ = m.prefill_tail(p, {"tokens": toks[:, 8:]}, kv_cache.paged_prefix_view(
        pc, row[:2], 8), 8)
    t2, _ = m.prefill_tail(sp, {"tokens": toks[:, 8:]}, kv_cache.paged_prefix_view(
        pcs, row[:2], 8), 8)
    same(t1, t2)
    pos = torch.tensor([12, 32], dtype=torch.int32)
    tok = {"token": toks[:, -1:].repeat(2, 1)}
    d1, _ = m.decode_step(p, pc, tok, pos)
    d2, _ = m.decode_step(sp, pcs, tok, pos)
    same(d1, d2)
    block = {"token": toks[:, 3:6].repeat(2, 1)}
    v1, st1 = m.verify_step(p, pc, block, pos + 1)
    v2, st2 = m.verify_step(sp, pcs, block, pos + 1)
    same(v1, v2)
    n_acc = torch.tensor([1, 0])
    m.verify_commit(st1, n_acc, pos + 1, 3, pc)
    m.verify_commit(st2, n_acc, pos + 1, 3, pcs)
    same(v1, v2)
    placed = sharded.place_cache(pc, axes, rules, mesh)
    for a, b in zip(placed, pcs):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------- the serves


@pytest.mark.parametrize("arch,over,shards,seed", [
    ("olmo-1b", {}, 2, 0), ("olmo-1b", {}, 4, 0),
    ("qwen2.5-32b", {"n_kv_heads": 2}, 2, 1),
    ("minicpm3-4b", {}, 2, 2), ("minicpm3-4b", {}, 4, 2),
    ("dbrx-132b", DBRX, 2, 3), ("dbrx-132b", DBRX, 4, 3),
    ("deepseek-v2-236b", {}, 2, 1), ("deepseek-v2-236b", {}, 4, 1),
])
def test_sharded_paged_serve_equals_single_device_and_reference(arch, over, shards, seed):
    """The reference's parity matrix (tests/test_sharded_serving.py): the
    port's sharded serve gives the port's single-device tokens and the
    reference's single-device tokens; the allocator ends in the same
    state."""
    jeng, eng = _engine(arch, **over)
    reqs = _trace(eng.model.cfg.vocab, seed=seed)
    want = jeng.serve(reqs, options=JOptions(paged=True))
    base = eng.serve(reqs, ServeOptions(paged=True))
    sig = eng._last_alloc.state_signature()
    rep = eng.serve(reqs, ServeOptions(paged=True, mesh=_mesh(shards)))
    assert _tokens(rep) == _tokens(base) == [r.tokens.tolist() for r in want.results]
    assert eng._last_alloc.state_signature() == sig and rep.leaked_blocks == 0


@pytest.mark.parametrize("case", ["contiguous", "prefix_share", "speculative", "pallas",
                                  "chunked_preempt", "int8_pallas", "mla_spec_pallas",
                                  "mla_chunked", "mrope", "moe_pallas", "moe_mla_pallas",
                                  "moe_a2a", "moe_expert_tp", "moe_uneven_spec"])
def test_sharded_serve_composes(case):
    """Every serving option composes with shards, as in the reference's
    matrix: tokens equal the port's single-device serve's and the
    reference's single-device serve's with the same options, and the
    counters the option reports (shared prefix tokens, accepted drafts,
    preemptions) equal the port's single-device serve's."""
    arch, over, shards, trace, kw = {
        "contiguous": ("olmo-1b", {}, 4, "random", dict()),
        "prefix_share": ("olmo-1b", {}, 4, "shared", dict(paged=True, prefix_share=True)),
        "speculative": ("olmo-1b", {}, 4, "random",
                        dict(paged=True, speculative=True, draft_k=3)),
        "pallas": ("olmo-1b", {}, 4, "random", dict(paged=True, kernel="pallas")),
        "chunked_preempt": ("olmo-1b", {}, 2, "pressure",
                            dict(slots=3, paged=True, block_size=4, prefill_chunk=4,
                                 preemption=True)),
        "int8_pallas": ("llama2-7b", {"kv_quant": True}, 4, "shared",
                        dict(paged=True, prefix_share=True, kernel="pallas")),
        "mla_spec_pallas": ("minicpm3-4b", {}, 2, "random",
                            dict(paged=True, speculative=True, draft_k=3, kernel="pallas")),
        "mla_chunked": ("minicpm3-4b", {}, 2, "shared",
                        dict(paged=True, prefix_share=True, prefill_chunk=4)),
        "mrope": ("qwen2-vl-7b", {"n_kv_heads": 2}, 2, "random",
                  dict(paged=True, kernel="pallas")),
        # the MoE family: K2 / K4's plain versions per shard, "a2a" (4
        # segments, so prompts of 4 and 8 tokens take the segment path),
        # "expert_tp", and 6 experts over 4 shards under speculative rounds
        "moe_pallas": ("dbrx-132b", DBRX, 4, "shared",
                       dict(paged=True, prefix_share=True, kernel="pallas")),
        "moe_mla_pallas": ("deepseek-v2-236b", {}, 4, "random",
                           dict(paged=True, kernel="pallas")),
        "moe_a2a": ("dbrx-132b", dict(DBRX, moe_impl="a2a", moe_a2a_segments=4), 2,
                    "random", dict(paged=True, kernel="pallas")),
        "moe_expert_tp": ("deepseek-v2-236b", {"moe_impl": "expert_tp"}, 2, "random",
                          dict(paged=True, kernel="pallas")),
        "moe_uneven_spec": ("dbrx-132b", dict(DBRX, n_experts=6), 4, "random",
                            dict(paged=True, speculative=True, draft_k=3)),
    }[case]
    jeng, eng = _engine(arch, **over)
    vocab = eng.model.cfg.vocab
    if trace == "shared":
        reqs = shared_prefix_trace(5, vocab, prefix_len=16, seed=4, suffix_lens=(2, 4),
                                   max_new_range=(4, 6))
    elif trace == "pressure":
        rng = np.random.default_rng(5)
        reqs = [tsch.Request(rid=i, prompt=rng.integers(0, vocab, (12,), dtype=np.int32),
                             max_new=8, arrival=a, seed=300 + i, priority=p)
                for i, (a, p) in enumerate(((0.0, 1), (0.0, 1), (1.0, 1), (4.0, 0)))]
    else:
        reqs = _trace(vocab, seed=5)
    want = jeng.serve(reqs, options=JOptions(**kw))
    base = eng.serve(reqs, ServeOptions(**kw))
    rep = eng.serve(reqs, ServeOptions(mesh=_mesh(shards), **kw))
    assert _tokens(rep) == _tokens(base) == [r.tokens.tolist() for r in want.results]
    for field in ("shared_prefill_tokens", "accepted_tokens", "drafted_tokens",
                  "preemptions", "resumes", "steps", "max_prefill_per_step",
                  "leaked_blocks"):
        assert getattr(rep, field) == getattr(base, field), field
    if case == "prefix_share":
        assert rep.shared_prefill_tokens > 0
    if case == "chunked_preempt":
        assert rep.preemptions > 0 and rep.max_prefill_per_step <= 4


def test_sharded_serve_cuts_learned_softmax_parameters():
    """A ConSmax model's per-head beta / gamma (drawn off their defaults) go
    to each shard cut to its heads: the sharded serve gives the
    single-device tokens."""
    m = Model(smoke_config("olmo-1b", softmax=SoftmaxSpec("consmax")), device="cpu")
    p = m.init(torch.Generator("cpu").manual_seed(0))
    smx = p["stack"]["layers"]["attn"]["smx"]
    g = torch.Generator().manual_seed(1)
    smx["beta"].copy_(torch.rand(smx["beta"].shape, generator=g) * 2)
    smx["gamma"].copy_(torch.rand(smx["gamma"].shape, generator=g) * 3 + 1)
    eng = Engine(m, p, max_new=6)
    reqs = _trace(m.cfg.vocab, seed=8)
    base = eng.serve(reqs, ServeOptions(paged=True))
    assert _tokens(eng.serve(reqs, ServeOptions(paged=True, mesh=_mesh(2)))) == _tokens(base)


def test_sharded_serve_keeps_per_shard_pools():
    """The serve's step state holds one cache per shard, each its pool slice
    and table: ``pool_report``'s ``per_device_bytes`` (1/4 of the pools at 4
    shards, plus the table), reset between serves like the single-device
    state; the shards are placed once per mesh."""
    _, eng = _engine("olmo-1b")
    reqs = _trace(eng.model.cfg.vocab, seed=7)
    opts = ServeOptions(paged=True, mesh=_mesh(4), cache_len=32, num_blocks=40)
    eng.serve(reqs, opts)
    st = next(s for k, s in eng._decode_states.items()
              if k[0] == "serve" and k[4:6] == (32, (16, 40)) and k[-1] == opts.mesh)
    assert isinstance(st.cache, Shards) and len(st.cache) == 4
    rep = sharded.pool_report(eng.model.cfg, 4, 32, 16, 40, 4)
    for c in st.cache:
        assert sum(t.numel() * t.element_size() for t in c.values()) == rep["per_device_bytes"]
    assert rep["partitioned_bytes"] // 4 + rep["replicated_bytes"] == rep["per_device_bytes"]
    params = eng._mesh_params[opts.mesh]
    eng.serve(reqs, opts)
    assert eng._mesh_params[opts.mesh] is params


def test_check_sharded_consistency_report():
    _, eng = _engine("olmo-1b")
    rep = sharded.check_sharded_consistency(eng, _trace(eng.model.cfg.vocab, seed=6),
                                            mesh=_mesh(2), paged=True)
    assert rep and rep.shards == 2 and rep.n_requests == 5 and rep.mismatched_rids == []


@pytest.mark.parametrize("arch,over,opts,exc,match", [
    ("mamba2-780m", {}, dict(paged=True), ValueError, "family 'ssm' decodes through"),
    ("hymba-1.5b", {}, dict(paged=True), ValueError, "family 'hybrid' decodes through"),
    ("whisper-base", {}, dict(), NotImplementedError,
     "unsupported option\\(s\\): mesh/shards"),
])
def test_headless_and_moe_families_raise(arch, over, opts, exc, match):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    m = Model(cfg, device="cpu")
    eng = Engine(m, m.init(torch.Generator("cpu").manual_seed(0)), max_new=2)
    req = [tsch.Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=2)]
    with pytest.raises(exc, match=match):
        eng.serve(req, ServeOptions(mesh=_mesh(2), **opts))


def test_shards_without_devices_and_across_devices_raise():
    """``shards=N`` takes visible devices only (one CPU here), and a mesh
    over two devices needs the process-per-device transport."""
    _, eng = _engine("olmo-1b")
    reqs = _trace(eng.model.cfg.vocab)
    with pytest.raises(ValueError, match="only 1 device\\(s\\) are visible"):
        eng.serve(reqs, ServeOptions(paged=True, shards=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 21"):
        eng.serve(reqs, ServeOptions(paged=True, mesh=make_serving_mesh(
            2, devices=[CPU, torch.device("meta")])))


def test_launcher_serves_shards_on_one_device(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu",
                      "--continuous", "--paged", "--kernel", "pallas", "--softmax",
                      "int_pallas", "--shards", "2", "--shards-on-one-device",
                      "--requests", "3", "--max-new", "4"])
    assert len(rep.results) == 3 and "2 shards on one device" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu",
                    "--continuous", "--paged", "--shards", "2"])
