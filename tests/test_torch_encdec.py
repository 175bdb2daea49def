"""The encoder-decoder family in the port (whisper-base smoke config: 3
encoder and 3 decoder layers, d 128, 4 heads of 32, layernorm, GELU, tied
embeddings, no rope) against the reference, on the reference's own
parameters carried over by ``repro_torch.convert``.

Tolerances, each case's own (f32 compute on both sides):

* The encoder (``_encode``: frames plus the sinusoid table, the dense
  stack with full attention, the final norm): within 1e-5 (the Alg.-1
  kinds too: on these inputs no score lands on a rounding boundary of the
  M-bit grid). The prefill cache's cross K/V, stored in bf16: within one
  bf16 ulp (relative 2^-7), the rounding of f32 values within 1e-5.
* Prefill, decode and ``train_logits`` logits: ``fp`` within 1e-4; the
  Alg.-1 kinds within 1e-2 (a score within an ulp of a rounding boundary
  may quantize to the neighbouring code on one side only,
  ``tests/test_torch_model.py``). Greedy tokens equal.
* Serving inside the port (bf16), bitwise: serve == per-request eager with
  the same frames; a second serve on the engine's kept cache == a fresh
  engine's. Against the reference (f32), on a trace where the reference's
  serve equals its own eager (asserted first): tokens and counters equal,
  CostReports bitwise.
* The options the reference refuses raise with its messages ("encdec",
  "frames"); a paged cache raises.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models.model import Model as JModel
from repro.serving import scheduler as jsch
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import kv_cache
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

ARCH = "whisper-base"
ATOL = {"fp": 1e-4, "int_pallas": 1e-2}
ENC = 16


def _frames(rng, b, n=ENC, d=128):
    return rng.normal(size=(b, n, d)).astype(np.float32)


_PAIRS = {}


def _pair(kind):
    if kind not in _PAIRS:
        jm = JModel(jsmoke(ARCH, softmax=JSpec(kind)), dtype=jnp.float32)
        jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
        tcfg = tsmoke(ARCH, softmax=SoftmaxSpec(kind))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[kind] = (jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp)
    return _PAIRS[kind]


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_config_and_param_tree_match_reference():
    """The full config is the reference's; the port's init draws the
    reference's tree, leaf for leaf in shape (meta device: no memory)."""
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.vocab) == ("encdec", 6, 512, 51865)
    jm = JModel(jsmoke(ARCH))
    shapes = jax.eval_shape(lambda k: jm.init_split(k)[0], jax.random.PRNGKey(0))
    tp = Model(tsmoke(ARCH), device="meta").init()

    def walk(j, t, path=""):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            assert tuple(j.shape) == tuple(t.shape), path

    walk(shapes, tp)
    conv = params_from_numpy(jax.tree.map(np.asarray, _pair("fp")[1]), tsmoke(ARCH), "cpu")
    assert conv["pos_embed"].dtype == torch.bfloat16
    assert conv["dec_stack"]["norm_x"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("kind", list(ATOL))
def test_encode_prefill_decode_match_reference(kind):
    jm, jp, tm, tp = _pair(kind)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s, steps = 2, 7, 3
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    fr = _frames(rng, b)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.as_tensor(toks, dtype=torch.long), "frames": torch.from_numpy(fr)}
    _close(jm._encode(jp, jb["frames"]), tm._encode(tp, tb["frames"], tm.ctx), 1e-5)
    jl, jc = jm.prefill(jp, jb, s + steps)
    tl, tc = tm.prefill(tp, tb, s + steps)
    _close(jl, tl, ATOL[kind])
    assert tc["cross"]["k"].shape == (cfg.n_layers, b, ENC, cfg.n_kv_heads, cfg.d_head)
    assert tc["cross"]["k"].dtype == torch.bfloat16
    for leaf in ("k", "v"):      # bf16 of f32 values within 1e-5: one bf16 ulp apart at most
        np.testing.assert_allclose(tc["cross"][leaf].float().numpy(),
                                   np.asarray(jc["cross"][leaf].astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=1e-5)
    _close(jm.train_logits(jp, jb)[0], tm.train_logits(tp, tb)[0], ATOL[kind])
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    for i in range(steps):
        # per-row positions, as a serving step passes them
        pos = np.full((b,), s + i, np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(nxt[:, None])}, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(nxt[:, None], dtype=torch.long)},
                                torch.from_numpy(pos))
        _close(jl, tl, ATOL[kind])
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy()), i


def test_scalar_and_row_offsets_agree():
    """``decode_step`` at an int position, a 0-d tensor and a [B] tensor
    gives the same logits and cache (the learned positions addressed per
    row); tail prefill and the verify step raise as the reference's."""
    _, _, tm, tp = _pair("fp")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 512, (2, 5))),
             "frames": torch.from_numpy(_frames(rng, 2))}
    tok = {"token": torch.as_tensor(rng.integers(0, 512, (2, 1)))}
    outs = []
    for pos in (5, torch.tensor(5), torch.tensor([5, 5])):
        _, c = tm.prefill(tp, batch, 8)
        logits, c = tm.decode_step(tp, c, tok, pos)
        outs.append((logits, c))
    for logits, c in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(kv_cache.tree_leaves(c),
                                                     kv_cache.tree_leaves(outs[0][1])))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tm.prefill_tail(tp, {"tokens": batch["tokens"]}, {}, 2)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tm.verify_step(tp, outs[0][1], {"token": batch["tokens"][:, :2]}, 5)


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-7b"])
def test_family_batch_matches_reference(arch):
    """``data.synthetic.family_batch`` gives the reference's frames
    (encdec) and text-only M-RoPE streams, array for array."""
    from repro.data.synthetic import family_batch as jbatch
    from repro_torch.data.synthetic import family_batch as tbatch

    j, t = jbatch(jsmoke(arch), 2, 8, seed=3), tbatch(tsmoke(arch), 2, 8, seed=3)
    assert set(j) == set(t) and ({"frames", "positions"} & set(t))
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_step_rules_on_the_card_only():
    """The encoder-decoder's step pads its head (``Model._head``) and
    computes each slot's attention scores as their own product
    (``Ctx.per_row_scores``) on a CUDA device only; both give the
    unpadded, batched results exactly (small integers in f64: every sum
    exact, whatever its order)."""
    from repro_torch.models.attention import attend
    from repro_torch.models.layers import Ctx, embed_logits

    m = Model(tsmoke(ARCH), device="cpu")
    assert not m.step_ctx.per_row_scores and m.step_ctx.step_min_rows == 0
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=g).to(torch.float64)

    w, x = {"w": ints(50, 16)}, ints(3, 1, 16)
    ctx = Ctx(dtype=torch.float64, step_min_rows=64, per_row_scores=True)
    assert torch.equal(embed_logits(w, x, ctx, 64), x @ w["w"].T)
    cfg = tsmoke(ARCH, softmax=SoftmaxSpec("fp"))
    q, k = ints(3, 1, 4, 8), ints(3, 7, 4, 8)
    mask = torch.rand((3, 1, 7), generator=g) < 0.7
    mask[:, :, 0] = True
    for m_ in (None, mask):
        assert torch.equal(attend(q, k, k, m_, cfg, ctx), attend(q, k, k, m_, cfg, Ctx(
            dtype=torch.float64)))


def test_cache_layouts():
    cfg = tsmoke(ARCH)
    c = kv_cache.cache_zeros(cfg, 3, 24, device="cpu", enc_len=ENC)
    assert c["self"]["k"].shape == (3, 3, 24, 4, 32)
    assert c["cross"]["v"].shape == (3, 3, ENC, 4, 32)
    # kv_quant leaves the encoder-decoder's caches in bf16, as the reference's
    q = kv_cache.cache_zeros(dataclasses.replace(cfg, kv_quant=True), 1, 8, device="cpu",
                             enc_len=4)
    assert {v.dtype for v in kv_cache.tree_leaves(q)} == {torch.bfloat16}
    with pytest.raises(NotImplementedError, match="decoder-only"):
        kv_cache.paged_cache_zeros(cfg, 2, 16, 4, 8, device="cpu")


# ---------------------------------------------------------------- serving


_PORTS = {}


def _port():
    if not _PORTS:
        m = Model(tsmoke(ARCH, softmax=SoftmaxSpec("int_pallas")), device="cpu")
        _PORTS["m"] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS["m"]


def _trace(cfg, seed=0, enc=ENC):
    rng = np.random.default_rng(seed)
    shapes = [(5, 6, 0.0), (3, 6, 0.0), (7, 5, 1.0), (9, 4, 2.0), (4, 6, 3.0)]
    return [tsch.Request(rid=i, prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=10 + i,
                         frames=_frames(rng, 1, enc, cfg.d_model)[0])
            for i, (p, n, a) in enumerate(shapes)]


def _eager_equal(m, params, reqs, rep):
    eng = Engine(m, params, max_new=6)
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len,
                           extra_inputs={"frames": r.frames[None]})
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str(r.rid))


def test_serve_equals_eager_and_kept_cache_serves_as_fresh():
    """Two serves on one engine (the kept cache reset between them, its
    storage kept) and a fresh engine's serve each equal the per-request
    eager generate with the same frames; the cross K/V are in the kept
    cache and reset to zeros."""
    m, params = _port()
    reqs = _trace(m.cfg)
    eng = Engine(m, params, max_new=6)
    first = eng.serve(reqs, ServeOptions(slots=2))
    (st,) = eng._decode_states.values()
    ptrs = [v.data_ptr() for v in kv_cache.tree_leaves(st.cache)]
    assert st.cache["cross"]["k"].shape[2] == ENC
    second = eng.serve(reqs, ServeOptions(slots=2))
    assert [v.data_ptr() for v in kv_cache.tree_leaves(st.cache)] == ptrs
    _eager_equal(m, params, reqs, first)
    for a, b in zip(first.results, second.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    st.reset_cache()
    assert all(not v.any() for v in kv_cache.tree_leaves(st.cache))


def test_serve_with_one_slot_per_request_order():
    """Slots reused by later requests (5 requests on 1 slot): each slot's
    cross K/V are its current request's."""
    m, params = _port()
    reqs = _trace(m.cfg, seed=3)
    _eager_equal(m, params, reqs, Engine(m, params, max_new=6).serve(reqs,
                                                                      ServeOptions(slots=1)))


def test_fused_generate_equals_eager():
    m, params = _port()
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, m.cfg.vocab, (2, 6)).astype(np.int32)
    fr = _frames(rng, 2)
    fused = Engine(m, params, max_new=5).generate(prompts, extra_inputs={"frames": fr})
    eager = Engine(m, params, max_new=5).generate(prompts, extra_inputs={"frames": fr},
                                                  mode="eager")
    np.testing.assert_array_equal(fused.tokens, eager.tokens)
    assert torch.equal(fused.logits, eager.logits)


@pytest.mark.parametrize("opts", [dict(paged=True), dict(speculative=True),
                                  dict(prefill_chunk=4),
                                  dict(paged=True, kernel="pallas", prefix_share=True)],
                         ids=["paged", "speculative", "prefill_chunk", "pallas"])
def test_rejects_options_like_reference(opts):
    m, params = _port()
    with pytest.raises(NotImplementedError, match="encdec"):
        Engine(m, params, max_new=6).serve(_trace(m.cfg), ServeOptions(slots=2, **opts))


def test_rejects_mixed_or_missing_frames():
    m, params = _port()
    eng, reqs = Engine(m, params, max_new=6), _trace(m.cfg)
    mixed = reqs[:1] + _trace(m.cfg, seed=1, enc=8)[1:2]
    missing = reqs[:1] + [dataclasses.replace(reqs[1], frames=None)]
    for bad in (mixed, missing):
        with pytest.raises(ValueError, match="frames"):
            eng.serve(bad, ServeOptions(slots=2))


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on the op behind ``int()`` / ``.item()`` of a tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor value back to the host")
        return func(*args, **(kwargs or {}))


def test_steps_read_nothing_back():
    """The serve step (one slot parked at ``cache_len``, past the position
    table's rows at cache_len == max_seq) and the fused generate step
    dispatch no host read: each can be captured as a CUDA graph."""
    m, params = _port()
    eng = Engine(m, params, max_new=4, eos_id=5)
    c = m.cfg.max_seq
    st = eng._serve_state("jnp", 2, c, None, None, ENC)
    st.buffers[0].copy_(torch.tensor([[7, 9], [3, c], [0, 1]]))
    with _NoHostRead():
        st.body()
    batch = {"tokens": torch.zeros((2, 6), dtype=torch.long),
             "frames": torch.from_numpy(_frames(np.random.default_rng(0), 2))}
    _, pre = m.prefill(params, batch, cache_len=12)
    gen = eng._generate_state(pre, 2)
    kv_cache.tree_map(lambda d, s: d.copy_(s), gen.cache, pre)
    with _NoHostRead():
        gen.body()


# ----------------------------------------------------------- the reference


def _ref_trace(cfg):
    """Four requests of two prompt lengths (few reference compilations)."""
    rng = np.random.default_rng(5)
    shapes = [(6, 5, 0.0), (9, 4, 0.0), (6, 6, 1.0), (9, 3, 2.0)]
    return [jsch.Request(rid=i, prompt=rng.integers(0, cfg.vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=300 + i,
                         frames=_frames(rng, 1, ENC, cfg.d_model)[0])
            for i, (p, n, a) in enumerate(shapes)]


def test_serve_matches_reference():
    jm, jp, tm, tp = _pair("int_pallas")
    jeng, teng = JEngine(jm, jp, max_new=8), Engine(tm, tp, max_new=8)
    jreqs = _ref_trace(jm.cfg)
    jrep = jeng.serve(jreqs, options=JOptions(slots=2, report_cost=True))
    for r, res in zip(jreqs, jrep.results):        # precondition: reference serve == eager
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len,
                            extra_inputs={"frames": jnp.asarray(r.frames[None])})
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    treqs = [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
             for r in jreqs]
    rep = teng.serve(treqs, ServeOptions(slots=2, report_cost=True))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    fields = ("steps", "prefill_tokens", "max_prefill_per_step", "cache_len")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}


def test_generate_cost_matches_reference():
    jm, jp, tm, tp = _pair("int_pallas")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jm.cfg.vocab, (2, 6)).astype(np.int32)
    fr = _frames(rng, 2)
    j = JEngine(jm, jp, max_new=4).generate(prompts, extra_inputs={"frames": jnp.asarray(fr)},
                                            report_cost=True)
    t = Engine(tm, tp, max_new=4).generate(prompts, extra_inputs={"frames": fr},
                                           report_cost=True)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    assert dataclasses.astuple(t.cost) == dataclasses.astuple(j.cost)


def test_reference_rejects_what_the_port_rejects():
    jm, jp, _, _ = _pair("fp")
    jeng, jreqs = JEngine(jm, jp, max_new=4), _ref_trace(jm.cfg)
    for opts in (dict(paged=True), dict(speculative=True), dict(prefill_chunk=4)):
        with pytest.raises(NotImplementedError, match="encdec"):
            jeng.serve(jreqs, options=JOptions(slots=2, **opts))
    bad = jreqs[:1] + [dataclasses.replace(jreqs[1], frames=None)]
    with pytest.raises(ValueError, match="frames"):
        jeng.serve(bad, options=JOptions(slots=2))
