"""The port's int8 KV cache (``cfg.kv_quant``) against the reference, and
the port's own int8 invariants.

* ``kv_quantize`` / ``kv_dequantize`` / ``kv_fake_quant`` and the EXAQ
  scales, bitwise against the reference's compiled functions (its served
  graph: XLA multiplies ``amax / 127.0`` by the f32 reciprocal there, as
  the port does; JAX run op by op divides instead and differs by an ulp of
  the scale). All three schemes, all-zero rows (the 1e-8 floor), exact
  powers of two and their float neighbours. Tier (b), stated where it
  applies: the port reads ``ceil(log2(s))`` and builds ``2^e`` from the f32
  bits exactly, while XLA's ``log2`` is inexact within an ulp of a power of
  two (its ``ceil`` can be one exponent off, so the scales differ by one
  power of two and the codes by at most one step of it) and its ``exp2`` of
  integers below -12 is off by up to 17 ulps (the 1e-8 floor's 2^-26 and
  the clamped scheme's 2^-16).
* Cache layouts equal ``cache_struct`` / ``paged_cache_struct``; MLA keeps
  its bf16 latent cache under ``kv_quant``, as the reference.
* olmo-1b smoke (f32, the reference's own parameters): int8 prefill and 8
  decode steps within the bounds of ``tests/test_torch_model.py``, greedy
  tokens equal; the int8 caches quantize f32 K/V that differ across the
  frameworks by float roundings, so their scales agree to 1e-5 relative
  and their codes within one step (tier b).
* Inside the port, bitwise: paged == contiguous decode, fused (K2's plain
  version) == gather, shared == private, serve == eager; and greedy tokens
  equal to the reference's serve in its ``paged`` and ``shared`` modes
  (``tests/test_kv_quant.py:106``), on a trace where the reference's own
  serve == eager is asserted first (ROADMAP.md's caution).
* K2's int8 plain version against the reference kernel in interpret mode
  (``tests/test_paged_kernel.py:116``): dequantized tiles bitwise, outputs
  bitwise but at a near-cancelling PV sum (one bf16 ulp).
* The ``--kv-quant --device cpu`` launcher; a ``cuda`` case holds K2's int8
  branch against its plain version on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core import quantization as jq
from repro.core.precision import BEST as JBEST
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.kernels.paged_attention import ops as jops
from repro.models import attention as jatt
from repro.models import kv_cache as jkv
from repro.models.model import Model as JModel
from repro.serving import scheduler as jsch
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as tq
from repro_torch.core.precision import BEST
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import attention as tatt
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

SCHEMES = ("absmax", "exaq", "exaq_clamped")
_jfake = jax.jit(jatt.kv_fake_quant, static_argnames="scheme")


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _quant_cfg(arch="olmo-1b", scheme="absmax", softmax="int_pallas"):
    return (dataclasses.replace(tsmoke(arch, softmax=SoftmaxSpec(softmax)), kv_quant=True,
                                kv_quant_scheme=scheme),
            dataclasses.replace(jsmoke(arch, softmax=JSpec(softmax)), kv_quant=True,
                                kv_quant_scheme=scheme))


# ------------------------------------------------------------ quantizers


def _kv_values(seed):
    """[2, 16, 4, 32] values at the magnitudes of a model's K/V (a row's
    amax of 0.1-30: scales 2^-10 to 2^-2), plus all-zero rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 4, 32)) * rng.choice([0.05, 1.0, 10.0], (2, 16, 4, 1))
    x[0, 3] = 0.0
    x[1, 7, 2] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_reference_bitwise(scheme, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _kv_values(SCHEMES.index(scheme))
    jc, js, jdq = _jfake(jnp.asarray(x, jd), scheme=scheme)
    tc, ts, tdq = tatt.kv_fake_quant(_t(x, td), scheme)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32 and tdq.dtype == td
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    live = np.abs(x).max(-1) > 0
    # the floor rows: absmax's 1e-8 is bitwise; EXAQ's 2^-26 is exact here
    # and up to 17 ulps off in XLA's exp2 (tier b), and every code is 0
    np.testing.assert_array_equal(ts.numpy()[live], np.asarray(js)[live])
    if scheme == "absmax":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        np.testing.assert_allclose(ts.numpy()[~live], np.asarray(js)[~live], rtol=4e-6)
        assert (ts.numpy()[~live] == {"exaq": 2.0 ** -26, "exaq_clamped": 2.0 ** -16}[scheme]).all()
    assert (tc.numpy()[~live] == 0).all()
    np.testing.assert_array_equal(tdq.float().numpy(), np.asarray(jdq, np.float32))
    back = tatt.kv_dequantize(tc, ts, td)
    assert torch.equal(back, tdq)


def test_kv_quantize_absmax_is_the_compiled_reference():
    """The reference's compiled graph multiplies by the f32 reciprocal of
    127; JAX op by op divides. The port follows the compiled graph."""
    x = _kv_values(7)
    amax = np.abs(x).max(-1)
    _, ts = tatt.kv_quantize(_t(x))
    assert (ts.numpy() == np.maximum(amax * np.float32(1 / 127), np.float32(1e-8))).all()
    _, eager = jatt.kv_quantize(jnp.asarray(x))
    assert (np.asarray(eager) == np.maximum(amax / np.float32(127), np.float32(1e-8))).all()


def _pow2_neighbourhood():
    """amax values whose amax/127 lands on, just above and just below exact
    powers of two from 2^-12 to 2^4."""
    p = np.ldexp(np.float32(1), np.arange(-12, 5)).astype(np.float32)
    s = np.concatenate([p, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(0))]).astype(np.float32)
    return (s / np.float32(1 / 127)).astype(np.float32), s


@pytest.mark.parametrize("scheme", ["exaq", "exaq_clamped"])
def test_exaq_scales_at_powers_of_two(scheme):
    """The port's EXAQ scale is the smallest power of two at or above
    max(amax / 127, 1e-8), exactly. The reference's ``log2`` near a power of
    two may put ``ceil`` one exponent off (tier b): its scale is then one
    power of two away, and never further."""
    amax, _ = _pow2_neighbourhood()
    jf = jax.jit(jq.exaq_scale if scheme == "exaq" else
                 lambda a: jq.exaq_scale_clamped(a, 5))
    got = (tq.exaq_scale(_t(amax)) if scheme == "exaq"
           else tq.exaq_scale_clamped(_t(amax), 5)).numpy()
    s = (amax * np.float32(1 / 127)).astype(np.float32)
    e = np.ceil(np.log2(s.astype(np.float64)))
    if scheme == "exaq_clamped":
        e = np.clip(e, -16, 15)
    np.testing.assert_array_equal(got, np.ldexp(np.float32(1), e.astype(int)))
    want = np.asarray(jf(jnp.asarray(amax)))
    ratio = np.log2(want.astype(np.float64) / got)
    assert np.all(np.abs(ratio) <= 1 + 1e-6)
    differ = want != got
    assert differ.sum() <= amax.size // 3, int(differ.sum())


@pytest.mark.parametrize("exp_bits", [3, 5])
def test_exaq_clamped_saturates_like_reference(exp_bits):
    amax = np.array([0.0, 1e-6, 1e-3, 0.05, 1.0, 300.0, 1e5], np.float32)
    got = tq.exaq_scale_clamped(_t(amax), exp_bits).numpy()
    want = np.asarray(jax.jit(lambda a: jq.exaq_scale_clamped(a, exp_bits))(jnp.asarray(amax)))
    np.testing.assert_allclose(got, want, rtol=4e-6)
    assert np.all(np.log2(got) == np.round(np.log2(got)))


# ------------------------------------------------------------ cache layouts


def _struct_of(cache):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()}


def _jstruct(struct):
    return {k: (tuple(v.shape), str(jnp.dtype(v.dtype))) for k, v in struct.items()}


@pytest.mark.parametrize("arch,quant", [("olmo-1b", True), ("olmo-1b", False),
                                        ("minicpm3-4b", True)])
def test_cache_layouts_match_reference(arch, quant):
    tcfg, jcfg = _quant_cfg(arch)
    if not quant:
        tcfg, jcfg = (dataclasses.replace(c, kv_quant=False) for c in (tcfg, jcfg))
    assert _struct_of(tkv.cache_zeros(tcfg, 2, 16, device="meta")) == \
        _jstruct(jkv.cache_struct(jcfg, 2, 16))
    assert _struct_of(tkv.paged_cache_zeros(tcfg, 2, 16, 4, 9, device="meta")) == \
        _jstruct(jkv.paged_cache_struct(jcfg, 2, 16, 4, 9))
    if arch == "minicpm3-4b":      # no int8 latent cache, as the reference
        assert set(tkv.cache_zeros(tcfg, 1, 8, device="meta")) == {"c_kv", "k_rope"}


def test_pool_ops_carry_scales_bitwise():
    """Scatter, copy-on-write and the prefix view move the scale leaves with
    their codes, as the reference's."""
    tcfg, jcfg = _quant_cfg()
    tc = tkv.paged_cache_zeros(tcfg, 2, 16, 4, 9)
    jc = jkv.paged_cache_zeros(jcfg, 2, 16, 4, 9)
    L, kv, dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.d_head
    rng = np.random.default_rng(1)
    vals = {"k": rng.integers(-127, 128, (L, 1, 7, kv, dh)).astype(np.int8),
            "v": rng.integers(-127, 128, (L, 1, 7, kv, dh)).astype(np.int8),
            "k_scale": rng.random((L, 1, 7, kv)).astype(np.float32),
            "v_scale": rng.random((L, 1, 7, kv)).astype(np.float32)}
    ids = np.array([6, 2], np.int32)
    row = np.array([6, 2, 9, 9], np.int32)
    wpos = np.arange(1, 7)
    pb, off = ids[wpos // 4], (wpos % 4).astype(np.int32)
    jc = jkv.paged_scatter(jc, {k: jnp.asarray(v) for k, v in vals.items()}, jnp.int32(1),
                           jnp.asarray(row), jnp.asarray(pb), jnp.asarray(off), t0=1, t1=7)
    tkv.paged_scatter(tc, {k: _t(v) for k, v in vals.items()}, 1, row, pb, off, 1, 7)
    jc = jkv.paged_copy_block(jc, jnp.int32(2), jnp.int32(4))
    tkv.paged_copy_block(tc, 2, 4)
    for k in tc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    want = jkv.paged_prefix_view(jc, jnp.asarray(ids), s=6)
    got = tkv.paged_prefix_view(tc, ids, 6)
    assert set(got) == {"k", "v", "k_scale", "v_scale"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------ the model, against the reference


@pytest.fixture(scope="module")
def pair():
    tcfg, jcfg = _quant_cfg()
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp


def test_int8_prefill_and_decode_steps_match_reference(pair):
    """Bounds of tests/test_torch_model.py (1e-2 for the int kinds); greedy
    tokens equal. The f32 K/V going into the quantizer differ across the
    frameworks by float roundings (~1e-6 relative), so the int8 caches are
    tier (b) too: scales within 1e-5 relative, codes within one step and
    equal at nearly every position."""
    jm, jp, tm, tp = pair
    prompts = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 8)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(prompts)}, cache_len=16)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)}, 16)
    assert _struct_of(tc) == {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-2)
    dec = jax.jit(jm.decode_step)
    for t in range(8):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok)
        jl, jc = dec(jp, jc, {"token": jnp.asarray(tok[:, None])}, jnp.int32(8 + t))
        tl, tc = tm.decode_step(
            tp, tc, {"token": torch.as_tensor(tok[:, None], dtype=torch.long)}, 8 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-2)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[f"{name}_scale"].numpy(),
                                   np.asarray(jc[f"{name}_scale"]), rtol=1e-5)
        dc = np.abs(tc[name].numpy().astype(int) - np.asarray(jc[name]).astype(int))
        assert dc.max() <= 1 and (dc == 0).mean() > 0.99, (name, dc.max(), (dc == 0).mean())


def test_int8_tail_prefill_matches_reference(pair):
    """A tail prefill against int8 prefix codes: the same logits and tail
    codes as the reference's, within the model bound."""
    jm, jp, tm, tp = pair
    tokens = np.random.default_rng(3).integers(0, jm.cfg.vocab, (1, 13)).astype(np.int32)
    _, jwhole = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(tokens)}, cache_len=13)
    _, twhole = tm.prefill(tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)}, 13)
    s = 8
    jl, jtail = jm.prefill_tail(jp, {"tokens": jnp.asarray(tokens[:, s:])},
                                {k: v[:, :, :s] for k, v in jwhole.items()}, prefix_len=s)
    tl, ttail = tm.prefill_tail(tp, {"tokens": torch.as_tensor(tokens[:, s:])},
                                {k: v[:, :, :s] for k, v in twhole.items()}, s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-2)
    assert set(ttail) == {"k", "v", "k_scale", "v_scale"}
    for k in ttail:
        assert ttail[k].dtype == twhole[k].dtype


# ------------------------------------------------------------ inside the port, bitwise


@pytest.fixture(scope="module")
def port():
    cfg, _ = _quant_cfg()
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _paged_from_contiguous(cache, bs, perm):
    """The same int8 cache contents in a paged pool with shuffled blocks."""
    L, b, c = cache["k"].shape[:3]
    nlog = c // bs
    nb = b * nlog + 3
    out = {"table": torch.full((L, b, nlog), nb, dtype=torch.int32)}
    for k, leaf in cache.items():
        pool = torch.zeros((L, nb, bs) + tuple(leaf.shape[3:]), dtype=leaf.dtype)
        for s in range(b):
            for j in range(nlog):
                pool[:, perm[s * nlog + j]] = leaf[:, s, j * bs:(j + 1) * bs]
        out[k] = pool
    for s in range(b):
        out["table"][:, s] = torch.as_tensor(perm[s * nlog:(s + 1) * nlog])
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_int8_paged_decode_equals_contiguous_gather_and_fused(port, scheme):
    """Four decode steps at per-slot positions (one slot parked): the paged
    int8 pool gives the contiguous int8 cache's logits and entries bit for
    bit, gathered (int_pallas) and through K2's int8 plain version
    (int_pallas_paged)."""
    m, params = port
    cfg = dataclasses.replace(m.cfg, kv_quant_scheme=scheme)
    mc = Model(cfg, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 6)))
    _, cont = mc.prefill(params, {"tokens": tokens}, cache_len=16)
    perm = rng.permutation(3 * 4 + 3)
    paged = {kind: _paged_from_contiguous(cont, 4, perm)
             for kind in ("int_pallas", "int_pallas_paged")}
    pos = torch.tensor([6, 9, 16], dtype=torch.int32)     # slot 2 parked
    for step in range(4):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 1)))
        lc, _ = mc.decode_step(params, cont, {"token": tok}, pos)
        for kind, cache in paged.items():
            mk = Model(cfg.with_softmax(SoftmaxSpec(kind)), dtype=torch.bfloat16,
                       device="cpu")
            lp, _ = mk.decode_step(params, cache, {"token": tok}, pos)
            assert torch.equal(lc[:2], lp[:2]), (step, kind)
        pos = pos + torch.tensor([1, 1, 0], dtype=torch.int32)
    for cache in paged.values():
        for k in ("k", "v", "k_scale", "v_scale"):
            back = tatt.paged_gather(cache[k][0], cache["table"][0])
            assert torch.equal(back[:2, :11], cont[k][0, :2, :11]), k


def _shared_trace(vocab, seed=1, n=4, pre_len=8, tail=4, max_new=4):
    """As tests/test_kv_quant.py: one 8-token prefix, 4-token tails."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (pre_len,), dtype=np.int32)
    arrivals = [0.0] + [6.0 + i for i in range(n - 1)]
    return [tsch.Request(rid=i, prompt=np.concatenate(
        [pre, rng.integers(0, vocab, (tail,), dtype=np.int32)]),
        max_new=max_new, arrival=arrivals[i], seed=200 + i) for i in range(n)]


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_int8_serve_equals_eager_and_shared_equals_private(port, kernel, scheme):
    m, params = port
    mq = Model(dataclasses.replace(m.cfg, kv_quant_scheme=scheme), dtype=torch.bfloat16,
               device="cpu")
    eng = Engine(mq, params, max_new=6)
    reqs = _shared_trace(mq.cfg.vocab, seed=3)
    base = ServeOptions(slots=2, cache_len=16, paged=True, block_size=4, kernel=kernel)
    priv = eng.serve(reqs, base)
    shared = eng.serve(reqs, dataclasses.replace(base, prefix_share=True))
    assert shared.shared_prefill_tokens > 0 and shared.leaked_blocks == 0
    assert shared.prefill_tokens < priv.prefill_tokens
    for r, a, b in zip(reqs, priv.results, shared.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=shared.cache_len)
        np.testing.assert_array_equal(b.tokens, ref.tokens[0], err_msg=str(r.rid))
    # the contiguous layout too
    cont = eng.serve(reqs, ServeOptions(slots=2, cache_len=16))
    for a, b in zip(cont.results, shared.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.fixture(scope="module")
def engines():
    tcfg, jcfg = _quant_cfg()
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return JEngine(jm, jp, max_new=6), Engine(Model(tcfg, dtype=torch.float32,
                                                    device="cpu"), tp, max_new=6)


@pytest.mark.parametrize("mode", ["paged", "shared"])
@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_int8_serve_matches_reference(engines, mode, kernel):
    """Greedy tokens, CostReports and the allocator's state equal the
    reference's int8 serve (f32 compute, its own parameters) in the modes
    of tests/test_kv_quant.py:106, on a trace where the reference's own
    serve == eager holds (asserted first)."""
    jeng, teng = engines
    kw = dict(slots=2, cache_len=16, paged=True, block_size=4, kernel=kernel,
              prefix_share=mode == "shared", report_cost=True)
    jreqs = [jsch.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                          arrival=r.arrival, seed=r.seed)
             for r in _shared_trace(jeng.model.cfg.vocab)]
    jrep = jeng.serve(jreqs, options=JOptions(**kw))
    for r, res in zip(jreqs, jrep.results):
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    rep = teng.serve(_shared_trace(jeng.model.cfg.vocab), ServeOptions(**kw))
    for a, b in zip(rep.results, jrep.results):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost)
    assert (rep.prefill_tokens, rep.shared_prefill_tokens, rep.leaked_blocks) == \
        (jrep.prefill_tokens, jrep.shared_prefill_tokens, jrep.leaked_blocks)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    if mode == "shared":
        assert rep.shared_prefill_tokens > 0


# ------------------------------------------------------------ K2's int8 branch


def _mixed_table(rng, B, NLOG, NB, BS, T):
    table = np.full((B, NLOG), NB, np.int32)
    perm = rng.permutation(NB)
    pi = 0
    positions = np.zeros((B, T), np.int32)
    for b in range(B):
        npages = int(rng.integers(1, NLOG + 1))
        table[b, :npages] = perm[pi:pi + npages]
        pi += npages
        positions[b] = int(rng.integers(0, npages * BS)) + np.arange(T)
    return table, positions


def _int8_inputs(r, B, t, H, D, NB, bs, kvh, nlog):
    q = r.normal(size=(B, t, H, D)).astype(np.float32)
    k = r.integers(-127, 128, (NB, bs, kvh, D)).astype(np.int8)
    v = r.integers(-127, 128, (NB, bs, kvh, D)).astype(np.int8)
    ks = (r.random((NB, bs, kvh)) * .1).astype(np.float32)
    vs = (r.random((NB, bs, kvh)) * .1).astype(np.float32)
    table, pos = _mixed_table(r, B, nlog, NB, bs, t)
    return q, k, v, ks, vs, table, pos


@pytest.mark.parametrize("bs,nlog", [(8, 4), (16, 4), (64, 2)])
@pytest.mark.parametrize("t,kvh,window", [(1, 2, 0), (1, 1, 0), (3, 2, 0), (1, 2, 12)])
def test_k2_int8_plain_matches_reference_kernel(bs, nlog, t, kvh, window):
    """K2's plain version on int8 pools against the reference's
    ``paged_attend_dense(..., k_scale, v_scale)`` in interpret mode (bf16
    compute). The dequantized tiles are bitwise equal; the outputs are
    bitwise but where the two frameworks' f32 PV sums, taken in different
    orders, straddle a bf16 rounding boundary (a near-cancelling output:
    one element of 384 in one case): there they are one bf16 ulp apart."""
    B, H, D = 3, 4, 32
    NB = B * nlog + 2
    r = np.random.default_rng(bs * 100 + nlog * 10 + t + kvh + window)
    q, k, v, ks, vs, table, pos = _int8_inputs(r, B, t, H, D, NB, bs, kvh, nlog)
    want = jops.paged_attend_dense(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(pos), JBEST, scale=D ** -0.5, window=window, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    before = (ops.paged_attention_rows.launches, ops.paged_attention_rows.int8_launches)
    got = ops.paged_attend_dense(_t(q, torch.bfloat16), _t(k), _t(v), _t(table), _t(pos),
                                 BEST, scale=D ** -0.5, window=window, k_scale=_t(ks),
                                 v_scale=_t(vs))
    assert (ops.paged_attention_rows.launches,
            ops.paged_attention_rows.int8_launches) == before
    assert got.dtype == torch.bfloat16 and got.shape == (B, t, H, D)
    np.testing.assert_array_equal(
        tatt.kv_dequantize(_t(k), _t(ks), torch.bfloat16).float().numpy(),
        np.asarray(jatt.kv_dequantize(jnp.asarray(k), jnp.asarray(ks), jnp.bfloat16),
                   np.float32))
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(g), np.abs(w)) + 1e-30)) - 7)
    assert np.all(np.abs(g - w) <= ulp) and (g != w).mean() <= 0.01


def test_k2_int8_rejects_half_quantized_inputs():
    q = torch.zeros((1, 2, 2, 8))
    pool = torch.zeros((2, 4, 2, 8), dtype=torch.int8)
    scale = torch.ones((2, 4, 2))
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        ops.paged_attention_rows(q, pool, pool, table, table[:, :1], BEST, scale=1.0,
                                 k_scale=scale)
    with pytest.raises(ValueError, match="scales take int8 pools"):
        ops.paged_attention_rows(q, pool.float(), pool.float(), table, table[:, :1], BEST,
                                 scale=1.0, k_scale=scale, v_scale=scale)


# ------------------------------------------------------------ launcher


def test_launcher_kv_quant_on_cpu():
    from repro_torch.launch import serve

    rep = serve.main(["--arch", "olmo-1b", "--smoke", "--continuous", "--paged",
                      "--prefix-share", "--kernel", "pallas", "--softmax", "int_pallas",
                      "--kv-quant", "--warm-steps", "0", "--device", "cpu",
                      "--requests", "4", "--max-new", "4"])
    assert len(rep.results) == 4 and rep.leaked_blocks == 0 and rep.cost.cycles > 0
    res = serve.main(["--arch", "minicpm3-4b", "--smoke", "--softmax", "int_pallas",
                      "--kv-quant", "--kv-quant-scheme", "exaq", "--warm-steps", "0",
                      "--device", "cpu", "--batch", "2", "--max-new", "3"])
    assert res.tokens.shape == (2, 8 + 3)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("bs,t,kvh,window", [(16, 1, 2, 0), (8, 3, 1, 12)])
def test_k2_int8_kernel_matches_plain_on_card(bs, t, kvh, window):
    """K2's int8 branch against its plain version: the dequantized tiles
    are bitwise the plain version's, so the plain Alg. 1 on the kernel's
    own scores gives its probabilities bitwise, and each score is within
    one bf16 ulp plus the f32 summation bound of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    r = np.random.default_rng(bs + t)
    S, H, D, nlog = 3, 4, 64, 8
    nb = S * nlog + 1
    q, k, v, ks, vs, table, pos = _int8_inputs(r, S, t, H, D, nb, bs, kvh, nlog)
    dev = "cuda"
    rows = t * (H // kvh)
    q = _t(q.reshape(S, t, kvh, H // kvh, D).transpose(0, 2, 1, 3, 4).reshape(
        S, kvh, rows, D), torch.bfloat16).to(dev)
    k, v, ks, vs = (_t(x).to(dev) for x in (k, v, ks, vs))
    table, pos = _t(table).to(dev), _t(pos).to(dev)
    sc = torch.zeros((S, kvh, rows, nlog * bs), device=dev)
    pr = torch.zeros_like(sc)
    kw = dict(scale=D ** -0.5, window=window, k_scale=ks, v_scale=vs)
    out = ops.paged_attention_rows(q, k, v, table, pos, BEST, scores_out=sc, probs_out=pr,
                                   **kw)
    want, want_sc, _ = paged_attention_ref(q, k, v, table, pos, BEST, return_rows=True, **kw)
    torch.cuda.synchronize()
    kpos = torch.arange(nlog * bs, device=dev)
    qp = pos.repeat_interleave(H // kvh, dim=1)[:, None, :, None]
    valid = kpos <= qp
    if window:
        valid &= kpos > qp - window
    valid = valid.expand(sc.shape)
    again = int_softmax_ref(sc.reshape(-1, nlog * bs), BEST,
                            valid.reshape(-1, nlog * bs)).reshape(sc.shape)
    assert torch.equal(again, pr)
    kd = tatt.kv_dequantize(tatt.paged_gather(k, table), tatt.paged_gather(ks, table),
                            torch.bfloat16).double()
    summed = 2 * D * 2.0 ** -24 * torch.einsum("skrd,slkd->skrl", q.double().abs(), kd.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(sc.abs(), want_sc.abs())
                                            .clamp_min(1e-30) / kw["scale"])) - 7)
    assert bool(((sc - want_sc).abs() <= (ulp + summed) * kw["scale"] * 1.001)[valid].all())
    assert bool(torch.isfinite(out).all()) and out.shape == want.shape
