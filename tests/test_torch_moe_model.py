"""The port's MoE models (dbrx-132b and deepseek-v2-236b smoke: 3 layers, d
128, 4 experts top-2, ``d_ff_expert`` 128; deepseek-v2 with its dense prefix
layer, MLA and one shared expert) against the reference's, on the
reference's own ``Model.init(PRNGKey(0))`` parameters carried over by
``repro_torch.convert``, f32 compute on both sides.

* The converter: every MoE leaf (router, stacked experts, shared GLU, the
  ``prefix`` stack) lands with ``Model.init``'s shapes; an unknown leaf or
  stack segment raises.
* ``train_logits`` (logits and aux), ``prefill``, six ``decode_step`` calls,
  a ``verify_step`` over a 4-token block and ``Engine.generate``: logits
  within 1e-4 (``fp``) / 2e-2 (``int_pallas``: a score within an ulp of a
  rounding boundary of the M-bit grid may quantize to the neighbouring
  code on one side only, ``tests/test_torch_model.py``; deepseek-v2's MLA
  reads 5e-4 at most steps and 0.0151 at its sixth decode step), aux
  within 1e-6,
  greedy tokens equal, CostReports equal exactly (the meter sees attention
  only: the router's softmax is plain, outside the backends). Every
  routing call of the port's run is first asserted to have its k-th and
  (k+1)-th probabilities more than 1e-6 apart, so XLA's and torch's
  roundings cannot swap an expert.
* Capture safety: the decode, verify and serve steps run on meta tensors
  and dispatch no host read on the CPU; the full widths count their
  published parameters on the meta device (4 layers).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro.serving.engine import Engine as JEngine
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import kv_cache, moe
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine, _to_meta

torch.set_num_threads(2)

ARCHS = ["dbrx-132b", "deepseek-v2-236b"]
ATOL = {"fp": 1e-4, "int_pallas": 2e-2}
AUX_ATOL = 1e-6
MARGIN = 1e-6
_PAIRS = {}


def _pair(arch, kind):
    if (arch, kind) not in _PAIRS:
        jm = JModel(jsmoke(arch, softmax=JSpec(kind)), dtype=jnp.float32)
        jp = jm.init_split(jax.random.PRNGKey(0))[0]
        tcfg = tsmoke(arch, softmax=SoftmaxSpec(kind))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[arch, kind] = (jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp)
    return _PAIRS[arch, kind]


@contextlib.contextmanager
def _routing_margins():
    """Records, over every MoE routing call inside, the smallest gap between
    a token's k-th and (k+1)-th router probability."""
    seen = []
    route = moe._route

    def recorded(p, x, cfg, ctx):
        if x.device.type == "meta":         # the engine's cost meter
            return route(p, x, cfg, ctx)
        probs = torch.softmax((x @ p["router"]["w"]).float(), -1)
        top = torch.sort(probs, -1, descending=True).values
        seen.append(float((top[..., cfg.moe_top_k - 1] - top[..., cfg.moe_top_k]).min()))
        return route(p, x, cfg, ctx)

    moe._route = recorded
    try:
        yield seen
    finally:
        moe._route = route


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


# ------------------------------------------------------------------- converter


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_lands_every_moe_leaf(arch):
    jm, jp, tm, tp = _pair(arch, "fp")
    init = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(tp) == _shapes(init)
    ffn = tp["stack"]["layers"]["ffn"]
    cfg = tm.cfg
    n = cfg.n_layers - cfg.n_dense_prefix
    assert ffn["gate"]["w"].shape == (n, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert ffn["down"]["w"].shape == (n, cfg.n_experts, cfg.d_ff_expert, cfg.d_model)
    assert ffn["router"]["w"].shape == (n, cfg.d_model, cfg.n_experts)
    if arch == "deepseek-v2-236b":
        assert tp["stack"]["prefix"]["ffn"]["down"]["w"].shape == (1, cfg.d_ff, cfg.d_model)
        assert ffn["shared"]["gate"]["w"].shape == (n, cfg.d_model, cfg.d_ff_expert)
    else:
        assert set(tp["stack"]) == {"layers"} and "shared" not in ffn
    for k in ("router", "gate", "down"):
        w = np.asarray(jp["stack"]["layers"]["ffn"][k]["w"])
        assert np.array_equal(ffn[k]["w"].numpy(), w)
    tree = jax.tree.map(np.asarray, jp)
    bad = tree["stack"]["layers"]["ffn"]
    bad["gate"] = {"experts": bad["gate"]["w"]}
    with pytest.raises(ValueError, match="experts"):
        params_from_numpy(tree, cfg, "cpu", torch.float32)
    tree = jax.tree.map(np.asarray, jp)
    tree["stack"]["suffix"] = tree["stack"]["layers"]
    with pytest.raises(ValueError, match="suffix"):
        params_from_numpy(tree, cfg, "cpu", torch.float32)


# ---------------------------------------------------------------- model parity


@pytest.mark.parametrize("kind", list(ATOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_aux(arch, kind):
    jm, jp, tm, tp = _pair(arch, kind)
    tokens = _tokens(2, 16, jm.cfg.vocab, seed=3)
    jlog, jaux = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(tokens)})
    with _routing_margins() as margins:
        tlog, taux = tm.train_logits(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    assert len(margins) == tm.cfg.n_layers - tm.cfg.n_dense_prefix
    assert min(margins) > MARGIN, margins
    _close(jlog, tlog, ATOL[kind])
    assert taux.shape == () and taux.dtype == torch.float32
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= AUX_ATOL


@pytest.mark.parametrize("kind", list(ATOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_verify(arch, kind):
    """Prefill, six greedy decode steps and a verify block, contiguous cache
    (every layer's leaves, the dense prefix's first)."""
    jm, jp, tm, tp = _pair(arch, kind)
    atol = ATOL[kind]
    prompts = _tokens(2, 8, jm.cfg.vocab)
    with _routing_margins() as margins:
        jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
            jp, {"tokens": jnp.asarray(prompts)}, cache_len=24)
        tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 24)
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        _close(jl, tl, atol)
        dec = jax.jit(jm.decode_step)
        for t in range(6):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok)
            jl, jc = dec(jp, jc, {"token": jnp.asarray(tok[:, None])}, jnp.int32(8 + t))
            tl, tc = tm.decode_step(
                tp, tc, {"token": torch.as_tensor(tok[:, None], dtype=torch.long)}, 8 + t)
            _close(jl, tl, atol)
        block = _tokens(2, 4, jm.cfg.vocab, seed=9)
        pos = np.asarray([14, 14], np.int32)
        jv, _ = jax.jit(jm.verify_step)(jp, jc, {"token": jnp.asarray(block)}, jnp.asarray(pos))
        tv, tc = tm.verify_step(tp, tc, {"token": torch.as_tensor(block, dtype=torch.long)},
                                torch.from_numpy(pos))
    assert min(margins) > MARGIN, min(margins)
    _close(jv, tv, atol)
    np.testing.assert_array_equal(tv.argmax(-1).numpy(), np.asarray(jv).argmax(-1))
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy()[:, :, :14], np.asarray(jc[k])[:, :, :14],
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_tail_and_generate_cost(arch):
    """A tail prefill against the reference's (the prefix split over the
    dense prefix and the MoE layers), then ``Engine.generate``: greedy
    tokens equal and the CostReport equal exactly."""
    jm, jp, tm, tp = _pair(arch, "int_pallas")
    tokens = _tokens(1, 12, jm.cfg.vocab, seed=4)
    s = 5
    _, jwhole = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, cache_len=12)
    jpre = jax.tree.map(lambda c: c[:, :, :s], jwhole)
    jl, jtail = jm.prefill_tail(jp, {"tokens": jnp.asarray(tokens[:, s:])}, jpre, s)
    tpre = {k: torch.from_numpy(np.array(v)) for k, v in jpre.items()}
    with _routing_margins() as margins:
        tl, ttail = tm.prefill_tail(tp, {"tokens": torch.as_tensor(tokens[:, s:],
                                                                    dtype=torch.long)}, tpre, s)
    assert min(margins) > MARGIN
    _close(jl, tl, ATOL["int_pallas"])
    for k in ttail:
        _close(jtail[k], ttail[k], ATOL["int_pallas"])
    short = _tokens(2, 6, jm.cfg.vocab, seed=6)
    ref = JEngine(jm, jp, max_new=5).generate(short, mode="eager", report_cost=True)
    with _routing_margins() as margins:
        got = Engine(tm, tp, max_new=5).generate(short, report_cost=True)
    assert min(margins) > MARGIN
    np.testing.assert_array_equal(got.tokens, np.asarray(ref.tokens))
    assert dataclasses.astuple(got.cost) == dataclasses.astuple(ref.cost)


# ---------------------------------------------------------------- capture safety


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor value back to the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_capturable(arch, kernel):
    """Decode and verify steps of the paged pool on meta tensors (a host read
    raises there), and the serve step on the CPU under a mode that fails on
    a host read."""
    cfg = tsmoke(arch, softmax=SoftmaxSpec("int_pallas"))
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    mcfg = cfg
    if kernel == "pallas":
        mcfg = cfg.with_softmax(dataclasses.replace(cfg.softmax, kind="int_pallas_paged"))
    meta = Model(mcfg, dtype=torch.bfloat16, device="meta")
    mparams = _to_meta(params)
    slots, C = 3, 16
    pos = torch.zeros((slots,), dtype=torch.int32, device="meta")
    cache = kv_cache.paged_cache_zeros(mcfg, slots, C, 4, 12, device="meta")
    for t in (1, 5):
        tok = torch.zeros((slots, t), dtype=torch.long, device="meta")
        step = meta.decode_step if t == 1 else meta.verify_step
        logits, out = step(mparams, cache, {"token": tok}, pos)
        assert logits.shape == (slots, t, cfg.vocab) and out is cache
    eng = Engine(m, params, max_new=4, eos_id=5)
    st = eng._serve_state(kernel, 2, 16, (4, 10))
    st.buffers[0].copy_(torch.tensor([[7, 9], [0, 16], [0, 1]]))   # slot 1 parked
    with _NoHostRead():
        st.body()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count_on_meta(arch):
    """Full width at 4 layers (the card's cut: full depth waits for item
    14): the published widths' parameters, drawn on the meta device."""
    cfg = get_config(arch, n_layers=4)
    params = Model(cfg, device="meta").init(torch.Generator())

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        assert tree.device.type == "meta"
        return tree.numel()

    n = count(params)
    assert abs(n - cfg.param_count()) < 1e-5 * n
    want = {"dbrx-132b": 14.27, "deepseek-v2-236b": 13.3}[arch]
    assert round(n / 1e9, 2) == want, n
