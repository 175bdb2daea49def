"""Serving under a softmax variant (``ServeOptions.softmax_kind``, ROADMAP
item 12) and the speculative verify round's rows (its repair), on the CPU.

* Inside the port, bitwise: ``serve(softmax_kind=k)`` equals a per-request
  eager generate of a model built with ``k`` (bf16; consmax, sole, mive,
  and the learnable ConSmax with non-default beta/gamma); ``ap_sim``'s
  serve equals ``int``'s; the target as its own draft under
  ``kernel="pallas"`` (the draft decoding through the fused paged kernel)
  accepts every proposal and equals the plain serve.
* Against the reference (f32, the reference's own parameters): greedy
  tokens of each variant's serve equal the reference's serve, on traces
  where the reference's serve equals its eager (asserted first, ROADMAP.md
  Queue 3's caution); CostReports equal exactly, and pin the golden values
  of ``tests/test_cost_golden.py``; ``kernel="pallas"`` rejects a variant
  with the reference's message.
* The launcher: ``--serve-softmax`` and ``--softmax ap_sim`` with
  ``--device cpu``.
* The verify round's repair, as far as the CPU sees it: K2's and K4's
  chunk plans are the decode step's at T 5 (``k2_split_plan`` /
  ``k4_split_plan`` with ``t``), K2's row groups never shrink a chunk, the
  down projection and the norms of decode and verify steps pad on the card
  only, and an engine says why its steps run op by op.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro.serving import scheduler as jsch
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro_torch.backends import get_backend
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.kernels.paged_attention.ref import (
    K2_TILE_BYTES, k2_chunks, k2_row_group, k2_span, k2_split_plan, k4_split_plan,
)
from repro_torch.launch import serve as launcher
from repro_torch.models import kv_cache
from repro_torch.models.layers import Ctx, dense_apply, norm_apply
from repro_torch.models.model import STEP_MIN_ROWS, Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

VARIANTS = ("consmax", "sole", "mive")
PAGED = dict(slots=2, paged=True, block_size=4, prefix_share=True)


@pytest.fixture(scope="module")
def port():
    cfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int"))
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _trace(vocab, n=4, seed=1):
    return tsch.shared_prefix_trace(n, vocab, prefix_len=9, seed=seed,
                                    suffix_lens=(2, 4, 7), max_new_range=(4, 7),
                                    arrival_spacing=1.0)


def _eager_equal(model, params, reqs, rep):
    eng = Engine(model, params, max_new=8)
    for r, res in zip(reqs, rep.results):
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(res.tokens, ref.tokens[0], err_msg=str(r.rid))


@pytest.mark.parametrize("kind", VARIANTS)
def test_variant_serve_equals_eager(port, kind):
    m, params = port
    reqs = _trace(m.cfg.vocab)
    rep = Engine(m, params, max_new=8).serve(
        reqs, ServeOptions(softmax_kind=kind, report_cost=True, **PAGED))
    assert rep.softmax_kind == kind and rep.cost.backend == kind and rep.cost.cycles > 0
    assert rep.step_replays == 0 and "cpu" in rep.op_by_op
    _eager_equal(Model(m.cfg.with_softmax(SoftmaxSpec(kind)), device="cpu"), params, reqs, rep)


def test_learnable_consmax_serve_equals_eager(port):
    """Non-default per-head beta/gamma reach every attention site of the
    serve (prefill, tail prefill, paged decode) as they reach eager's."""
    m, params = port
    cfg = m.cfg.with_softmax(SoftmaxSpec("consmax"))
    rng = np.random.default_rng(4)
    shape = (cfg.n_layers, cfg.n_heads)
    lp = dict(params, stack={"layers": dict(params["stack"]["layers"], attn=dict(
        params["stack"]["layers"]["attn"], smx={
            "beta": torch.from_numpy(rng.uniform(-1.5, 0.5, shape).astype(np.float32)),
            "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))}))})
    lm = Model(cfg, device="cpu")
    reqs = _trace(cfg.vocab, seed=2)
    rep = Engine(lm, lp, max_new=8).serve(reqs, ServeOptions(**PAGED))
    _eager_equal(lm, lp, reqs, rep)
    default = Engine(lm, params, max_new=8).serve(reqs, ServeOptions(**PAGED))
    assert any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(rep.results, default.results))


def test_ap_sim_serve_equals_int(port):
    m, params = port
    reqs = _trace(m.cfg.vocab, seed=3)
    eng = Engine(m, params, max_new=8)
    a = eng.serve(reqs, ServeOptions(softmax_kind="ap_sim", report_cost=True, **PAGED))
    b = eng.serve(reqs, ServeOptions(softmax_kind="int", report_cost=True, **PAGED))
    for x, y in zip(a.results, b.results):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert a.cost.backend == "ap_sim" and b.cost.backend == "int_jax"
    assert dataclasses.astuple(a.cost)[1:] == dataclasses.astuple(b.cost)[1:]


def test_self_draft_through_paged_kernel_accepts_all(port):
    """Under ``kernel="pallas"`` the draft model decodes through the fused
    paged kernel over its stripes seen as a pool, so the target as its own
    draft proposes exactly the target's tokens."""
    m, params = port
    pm = Model(m.cfg.with_softmax(SoftmaxSpec("int_pallas")), device="cpu")
    reqs = _trace(m.cfg.vocab, seed=5)
    eng = Engine(pm, params, max_new=8)
    opts = ServeOptions(kernel="pallas", **PAGED)
    base = eng.serve(reqs, opts)
    spec = eng.serve(reqs, dataclasses.replace(opts, speculative=True, draft_k=3,
                                               draft="model", draft_model=pm,
                                               draft_params=params))
    for a, b in zip(spec.results, base.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert spec.acceptance_rate == 1.0 and spec.steps < base.steps
    (proposer, _, _), = eng._proposers.values()
    (st,) = proposer._states.values()
    assert "table" in st.cache
    assert st.model.cfg.softmax.kind == "int_pallas_paged"


def test_contiguous_as_paged_is_a_view():
    cfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int"))
    stripes = kv_cache.cache_zeros(cfg, 3, 16, device="cpu")
    pool = kv_cache.contiguous_as_paged(stripes, 4)
    assert pool["table"].tolist()[0] == [[4 * b + j for j in range(4)] for b in range(3)]
    pool["k"][:, 4 * 2 + 1, 3] = 1.0                 # slot 2, position 7
    assert bool((stripes["k"][:, 2, 7] == 1).all()) and int(stripes["k"].count_nonzero()) == \
        pool["k"][:, 9, 3].numel()
    with pytest.raises(ValueError, match="multiple"):
        kv_cache.contiguous_as_paged(kv_cache.cache_zeros(cfg, 1, 10, device="cpu"), 4)


# ------------------------------------------------------------ against the reference


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke("olmo-1b", softmax=JSpec("int"))
    tcfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int"))
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return (JEngine(jm, jp, max_new=8),
            Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp, max_new=8), jp)


def _port_trace(jreqs):
    return [tsch.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                         arrival=r.arrival, seed=r.seed) for r in jreqs]


@pytest.mark.parametrize("kind", VARIANTS + ("ap_sim",))
def test_variant_serve_matches_reference(pair, kind):
    jeng, teng, jp = pair
    jreqs = jsch.shared_prefix_trace(4, jeng.model.cfg.vocab, prefix_len=9, seed=4,
                                     suffix_lens=(2, 4, 7), max_new_range=(4, 6),
                                     arrival_spacing=1.0)
    kw = dict(slots=2, cache_len=32, paged=True, block_size=4, prefix_share=True,
              report_cost=True, softmax_kind=kind)
    jrep = jeng.serve(jreqs, options=JOptions(**kw))
    # precondition: the reference's serve equals its eager of the variant model
    jvar = JEngine(JModel(jeng.model.cfg.with_softmax(JSpec(kind)), dtype=jnp.float32), jp,
                   max_new=8)
    for r, res in zip(jreqs, jrep.results):
        ref = jvar.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    rep = teng.serve(_port_trace(jreqs), ServeOptions(**kw))
    for a, b in zip(rep.results, jrep.results):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()


def test_variant_costs_pin_golden_values(pair):
    """The variants' per-vector Table-II cost at BEST, seq 64, through the
    serving meter: the frozen values of ``tests/test_cost_golden.py``."""
    pins = {"consmax": (1572, 2.2661952e-09), "sole": (1434, 3.0423744e-09),
            "mive": (1144, 2.2404096e-09), "int": (1893, 4.1706576e-09),
            "ap_sim": (1893, 4.1706576e-09)}
    for kind, (cycles, energy) in pins.items():
        rep = get_backend(kind).meter((1, 64))
        assert rep.vectors == 1 and rep.cycles == cycles, kind
        assert rep.energy_j == pytest.approx(energy)
        assert rep.latency_s == pytest.approx(cycles * 1e-9)


@pytest.mark.parametrize("kind", VARIANTS)
def test_pallas_rejects_variant_like_reference(pair, kind):
    jeng, teng, _ = pair
    reqs = jsch.random_trace(2, jeng.model.cfg.vocab, seed=0, prompt_lens=(4, 6),
                             max_new_range=(2, 3))
    opts = dict(paged=True, block_size=4, kernel="pallas", softmax_kind=kind)
    with pytest.raises(ValueError) as want:
        jeng.serve(reqs, options=JOptions(**opts))
    with pytest.raises(ValueError) as got:
        teng.serve(_port_trace(reqs), ServeOptions(**opts))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- launcher


@pytest.mark.parametrize("argv", [
    ["--continuous", "--paged", "--prefix-share", "--softmax", "int",
     "--serve-softmax", "consmax"],
    ["--continuous", "--paged", "--softmax", "int", "--serve-softmax", "ap_sim"],
    ["--softmax", "ap_sim"],
    ["--softmax", "sole", "--M", "6", "--N", "16"],
])
def test_launcher_runs_variants(argv, capsys):
    res = launcher.main(["--arch", "olmo-1b", "--warm-steps", "0", "--device", "cpu",
                         "--requests", "3", "--max-new", "4"] + argv)
    out = capsys.readouterr().out
    assert "softmax AP cost" in out and "cycles=" in out
    if "--serve-softmax" in argv:
        assert res.softmax_kind == argv[-1]
        assert f"backend='{argv[-1]}'" in out


# ------------------------------------------------ the verify round's repair


@pytest.mark.parametrize("slots,kv,group,nlog,bs", [
    (8, 16, 1, 36, 16), (8, 4, 8, 36, 16), (1, 4, 7, 2048, 16), (8, 8, 1, 2048, 16),
    (2, 16, 1, 1024, 16), (3, 2, 4, 40, 8)])
def test_k2_verify_plan_is_the_decode_plan(slots, kv, group, nlog, bs):
    """At T 5 a row is split at the decode step's page boundaries: the same
    pages per chunk as at T 1, whatever the tile budget; when the T rows'
    score tile exceeds it, the rows go in groups that fit, and never the
    chunk is shrunk."""
    decode = k2_split_plan(slots, kv, group, nlog, bs, 132)
    verify = k2_split_plan(slots, kv, 5 * group, nlog, bs, 132, 5)
    assert verify == decode
    rg = k2_row_group(5 * group, verify, bs)
    assert 1 <= rg <= 5 * group
    assert rg == 5 * group or 4 * rg * verify * bs <= K2_TILE_BYTES
    assert 4 * group * decode * bs <= K2_TILE_BYTES or decode == 1
    pos = [nlog * bs - 7]
    chunks_t1 = k2_chunks(*k2_span(pos, nlog, bs), decode)
    chunks_t5 = k2_chunks(*k2_span([pos[0] + t - 2 for t in range(5)], nlog, bs), verify)
    assert chunks_t5[:len(chunks_t1)] == chunks_t1


def test_k2_row_groups_when_the_tile_overflows():
    """A decode plan of 256 pages (8 slots x 8 heads over 32768 keys) holds
    a 3-row score tile: a T-5 block runs in groups of 3 rows."""
    cp = k2_split_plan(8, 8, 5, 2048, 16, 132, 5)
    assert cp == k2_split_plan(8, 8, 1, 2048, 16, 132) == 256
    assert k2_row_group(5, cp, 16) == 3 and k2_row_group(1, cp, 16) == 1


@pytest.mark.parametrize("slots,heads,nlog,bs", [(8, 40, 34, 16), (2, 40, 256, 16),
                                                 (2, 128, 256, 16), (3, 4, 4, 8)])
def test_k4_verify_plan_is_the_decode_plan(slots, heads, nlog, bs):
    """K4 plans from the decode step's rows (the heads) too: minicpm3-4b's
    verify round (200 rows) takes the decode step's 2 pages a chunk, not
    the 8 its own row count would give."""
    decode = k4_split_plan(slots, heads, nlog, bs, 132)
    assert k4_split_plan(slots, 5 * heads, nlog, bs, 132, 5) == decode
    if (slots, heads, nlog) == (8, 40, 34):
        assert decode == 2 and k4_split_plan(slots, 5 * heads, nlog, bs, 132) == 8


def test_step_padding_on_the_card_only():
    """Decode and verify steps pad the down projection and the norms to
    STEP_MIN_ROWS rows on a CUDA device (``Model.step_ctx``) and nowhere
    else; the padded product's and norm's rows are the unpadded ones
    exactly (f64)."""
    m = Model(tsmoke("olmo-1b"), device="cpu")
    assert m.step_ctx.step_min_rows == 0 and m.step_ctx.min_rows == 0
    assert m.prefill_ctx.step_min_rows == 0
    assert STEP_MIN_ROWS == 64
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((48, 24), generator=g, dtype=torch.float64)}
    x = torch.randn((2, 5, 48), generator=g, dtype=torch.float64)
    ctx = Ctx(dtype=torch.float64, step_min_rows=STEP_MIN_ROWS)
    assert torch.equal(dense_apply(p, x, ctx, ctx.step_min_rows), x @ p["w"])
    assert torch.equal(dense_apply(p, x, ctx), x @ p["w"])
    plain = Ctx(dtype=torch.float64)
    for kind, q in (("layernorm_np", {}), ("rmsnorm", {"scale": torch.rand(48, dtype=torch.float64)}),
                    ("layernorm", {"scale": torch.rand(48, dtype=torch.float64),
                                   "bias": torch.rand(48, dtype=torch.float64)})):
        y = norm_apply(q, x, kind, ctx)
        assert y.shape == x.shape and torch.equal(y, norm_apply(q, x, kind, plain)), kind


def test_engine_names_why_steps_run_op_by_op(port):
    """On a CUDA device a step is graphed unless graphs are off or the
    softmax backend is not capturable (ap_sim reads the device back on the
    host); no other backend takes that branch."""
    m, params = port
    eng = Engine(m, params)
    card = types.SimpleNamespace(device=torch.device("cuda"), cfg=m.cfg)
    assert eng._op_by_op_reason(card) is None
    for kind in ("int", "int_pallas", "int_pallas_paged", "fp", "consmax", "sole", "mive"):
        card.cfg = m.cfg.with_softmax(SoftmaxSpec(kind))
        assert eng._op_by_op_reason(card) is None, kind
    card.cfg = m.cfg.with_softmax(SoftmaxSpec("ap_sim"))
    assert "'ap_sim'" in eng._op_by_op_reason(card)
    eng._cuda_graphs = False
    card.cfg = m.cfg
    assert "off" in eng._op_by_op_reason(card)
    assert "cpu" in eng._op_by_op_reason()
