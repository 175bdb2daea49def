"""The M-RoPE family in the port (qwen2-vl-7b smoke config: 3 layers, d
128, GQA 4/4 heads of 32, sections (4, 6, 6), QKV biases) against the
reference, on the reference's own parameters carried over by
``repro_torch.convert`` (with the QKV biases redrawn non-zero on both
sides: the reference initializes them to zero, which would leave the bias
add unseen).

Tolerances, each case's own:

* ``apply_mrope`` on random, DISTINCT [3, B, S] streams: within 1e-5 of
  the reference (f32; XLA's and torch's cos / sin differ by an ulp or
  two). With the three streams equal it is bitwise ``apply_rope``; with
  the sections rotated it is not (the split is visible).
* Prefill and decode logits (f32 compute) at distinct streams and under
  the VLM stub's ``embeds_override``: ``fp`` within 1e-4; the Alg.-1 kinds
  within 1e-2 (a score within an ulp of a rounding boundary of the M-bit
  grid may quantize to the neighbouring code on one side only,
  ``tests/test_torch_model.py``). Greedy tokens equal.
* Serving, inside the port (bf16), bitwise: serve == per-request eager
  (contiguous, paged, paged with ``kernel="pallas"``: K2's plain version,
  and that from an int8 pool),
  chunked (prompts prefill whole: no tail prefill for M-RoPE) == plain.
  Against the reference (f32), on a trace where the reference's serve
  equals its own eager (asserted first): tokens, counters and allocator
  state equal, CostReports bitwise.
* The serve step builds its position streams from its input buffer's
  position row, so a CUDA-graph replay sees each step's; no step reads a
  value back to the host.
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
from repro.models.layers import apply_mrope as japply_mrope
from repro.models.model import Model as JModel
from repro.serving import scheduler as jsch
from repro.serving.engine import Engine as JEngine
from repro.serving.options import ServeOptions as JOptions
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import kv_cache
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

ARCH = "qwen2-vl-7b"
ATOL = {"fp": 1e-4, "int_pallas": 1e-2}


def _streams(rng, b, s, hi=4096):
    """Three different position streams [3, b, s]: t constant over an image
    block, h and w walking its rows and columns, then a text ladder (the
    Qwen2-VL layout), shifted per row so the batch rows differ too."""
    pos = np.empty((3, b, s), np.int32)
    grid = s // 2
    side = max(1, int(grid ** 0.5))
    for row in range(b):
        base = int(rng.integers(0, hi // 2))
        k = np.arange(grid)
        pos[0, row, :grid] = base
        pos[1, row, :grid] = base + k // side
        pos[2, row, :grid] = base + k % side
        top = pos[:, row, :grid].max() + 1
        pos[:, row, grid:] = top + np.arange(s - grid)[None]
    return pos


def test_smoke_config_matches_reference():
    j, t = jsmoke(ARCH), tsmoke(ARCH)
    assert t.mrope_sections == j.mrope_sections == (4, 6, 6)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    full = get_config(ARCH)
    assert full.rope_type == "mrope" and full.qkv_bias and full.n_kv_heads == 4


@pytest.mark.parametrize("d,sections", [(32, (4, 6, 6)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference_on_distinct_streams(d, sections):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 16, 4, d)).astype(np.float32)
    pos = _streams(rng, 2, 16)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = np.asarray(japply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the split is visible: rotated sections give another result
    rot = sections[1:] + sections[:1]
    other = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, rot)
    assert float((other - got).abs().max()) > 1e-2
    # equal streams: bitwise plain rope, whatever the sections
    same = torch.from_numpy(np.broadcast_to(pos[2], pos.shape).copy())
    assert torch.equal(apply_mrope(torch.from_numpy(x), same, 1e6, rot),
                       apply_rope(torch.from_numpy(x), same[0], 1e6))
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 4, 4))


def _with_biases(tree, rng):
    """The QKV biases of every layer drawn N(0, 0.1) (the same arrays go to
    both packages)."""
    out = jax.tree.map(np.asarray, tree)
    attn = out["stack"]["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name]["b"] = rng.normal(0, 0.1, b.shape).astype(np.float32)
    return out


_PAIRS = {}


def _pair(kind):
    if kind not in _PAIRS:
        jm = JModel(jsmoke(ARCH, softmax=JSpec(kind)), dtype=jnp.float32)
        tree = _with_biases(jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0)),
                            np.random.default_rng(11))
        jp = jax.tree.map(jnp.asarray, tree)
        tcfg = tsmoke(ARCH, softmax=SoftmaxSpec(kind))
        tp = params_from_numpy(tree, tcfg, "cpu", torch.float32)
        _PAIRS[kind] = (jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp)
    return _PAIRS[kind]


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("override", [False, True], ids=["text", "embeds_override"])
@pytest.mark.parametrize("kind", list(ATOL))
def test_prefill_and_decode_match_reference(kind, override):
    jm, jp, tm, tp = _pair(kind)
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    b, s, steps = 2, 12, 3
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pos = _streams(rng, b, s)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.as_tensor(toks, dtype=torch.long), "positions": torch.from_numpy(pos)}
    if override:
        emb = rng.normal(0, 0.02, (b, s, cfg.d_model)).astype(np.float32)
        mask = np.zeros((b, s), bool)
        mask[:, : s // 2] = True                # the image block's rows
        jb.update(embeds_override=jnp.asarray(emb), override_mask=jnp.asarray(mask))
        tb.update(embeds_override=torch.from_numpy(emb), override_mask=torch.from_numpy(mask))
    cache_len = s + steps
    jl, jc = jm.prefill(jp, jb, cache_len)
    tl, tc = tm.prefill(tp, tb, cache_len)
    _close(jl, tl, ATOL[kind])
    jt = np.asarray(jm.train_logits(jp, jb)[0])
    _close(jt, tm.train_logits(tp, tb)[0], ATOL[kind])
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    top = pos.max(axis=(0, 2)) + 1                 # the text ladder goes on
    for i in range(steps):
        p = np.broadcast_to((top + i)[None, :, None], (3, b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"token": jnp.asarray(nxt[:, None]),
                                         "positions": jnp.asarray(p)}, s + i)
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(nxt[:, None], dtype=torch.long),
                                         "positions": torch.from_numpy(p)}, s + i)
        _close(jl, tl, ATOL[kind])
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy()), i


def test_tail_prefill_and_verify_raise_as_reference():
    _, _, tm, tp = _pair("fp")
    with pytest.raises(NotImplementedError, match="scalar-position rope"):
        tm.prefill_tail(tp, {"tokens": torch.zeros((1, 2), dtype=torch.long)}, {}, 4)
    with pytest.raises(NotImplementedError, match="scalar-position rope"):
        tm.verify_step(tp, {}, {"token": torch.zeros((1, 2), dtype=torch.long)}, 4)


# ---------------------------------------------------------------- serving


_PORTS = {}


def _port():
    if not _PORTS:
        m = Model(tsmoke(ARCH, softmax=SoftmaxSpec("int_pallas")), device="cpu")
        _PORTS["m"] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS["m"]


def _trace(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 6, 0.0), (3, 6, 0.0), (7, 5, 1.0), (12, 4, 2.0), (4, 6, 3.0)]
    return [tsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=10 + i)
            for i, (p, n, a) in enumerate(shapes)]


def _ladder(p):
    return np.broadcast_to(np.arange(p, dtype=np.int32)[None, None], (3, 1, p))


@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged-pallas", "int8-pallas"])
def test_serve_equals_eager(layout):
    m, params = _port()
    if layout == "int8-pallas":
        m = Model(dataclasses.replace(m.cfg, kv_quant=True), device="cpu")
    reqs = _trace(m.cfg.vocab)
    kw = {"contiguous": {}, "paged": dict(paged=True, block_size=4),
          "paged-pallas": dict(paged=True, block_size=4, kernel="pallas"),
          "int8-pallas": dict(paged=True, block_size=4, kernel="pallas")}[layout]
    rep = Engine(m, params, max_new=6).serve(reqs, ServeOptions(slots=2, **kw))
    eng = Engine(m, params, max_new=6)
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len,
                           extra_inputs={"positions": _ladder(r.prompt_len)})
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str(r.rid))


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefills_whole_and_equals_plain(paged):
    m, params = _port()
    reqs = _trace(m.cfg.vocab, seed=1)
    kw = dict(slots=2, paged=True, block_size=4) if paged else dict(slots=2)
    plain = Engine(m, params, max_new=6).serve(reqs, ServeOptions(**kw))
    chunked = Engine(m, params, max_new=6).serve(reqs, ServeOptions(prefill_chunk=4, **kw))
    assert chunked.max_prefill_per_step == max(r.prompt_len for r in reqs)
    for a, b in zip(chunked.results, plain.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_fused_generate_equals_eager():
    m, params = _port()
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, m.cfg.vocab, (2, 6)).astype(np.int32)
    pos = _streams(rng, 2, 6, hi=64)
    fused = Engine(m, params, max_new=5).generate(prompts, extra_inputs={"positions": pos})
    eager = Engine(m, params, max_new=5).generate(prompts, extra_inputs={"positions": pos},
                                                  mode="eager")
    np.testing.assert_array_equal(fused.tokens, eager.tokens)
    assert torch.equal(fused.logits, eager.logits)


def test_rejects_options_like_reference():
    m, params = _port()
    eng, reqs = Engine(m, params, max_new=6), _trace(m.cfg.vocab)
    for opts in (dict(slots=2, paged=True, prefix_share=True), dict(slots=2, speculative=True)):
        with pytest.raises(NotImplementedError, match="mrope"):
            eng.serve(reqs, ServeOptions(**opts))


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on the op behind ``int()`` / ``.item()`` of a tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor value back to the host")
        return func(*args, **(kwargs or {}))


def test_serve_step_positions_follow_its_position_row():
    """The serve step builds M-RoPE's three streams from its input
    buffer's position row (text-only decode, as the reference's serve
    step) and reads nothing back to the host, so a replay sees each
    step's positions."""
    m, params = _port()
    eng = Engine(m, params, max_new=4)
    st = eng._serve_state("pallas", 2, 16, (4, 8))
    assert st.buffers[0].shape == (3, 2) and not st.draws
    st.cache["table"][:, 0, :2] = torch.tensor([0, 1], dtype=torch.int32)
    st.cache["table"][:, 1, :2] = torch.tensor([2, 3], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    for name in ("k", "v"):        # earlier keys: a lone token's score is rotation-free
        pool = st.cache[name]
        pool.copy_(torch.randn(pool.shape, generator=g).to(pool.dtype))
    rows = torch.tensor([[7, 9], [5, 6], [0, 0]])
    st.buffers[0].copy_(rows)
    snap = [v.clone() for v in kv_cache.tree_leaves(st.cache)]
    with _NoHostRead():
        _, logits = st.body()
    for leaf, v in zip(kv_cache.tree_leaves(st.cache), snap):
        leaf.copy_(v)
    want, _ = eng._kernel_model("pallas").decode_step(
        params, st.cache, {"token": rows[0][:, None],
                           "positions": rows[1].expand(3, 2)[:, :, None]}, rows[1])
    assert torch.equal(logits, want[:, -1])


def test_generate_step_reads_nothing_back():
    m, params = _port()
    eng = Engine(m, params, max_new=4, eos_id=5)
    batch = {"tokens": torch.zeros((2, 6), dtype=torch.long),
             "positions": torch.from_numpy(_streams(np.random.default_rng(0), 2, 6, hi=32))}
    _, pre = m.prefill(params, batch, cache_len=12)
    gen = eng._generate_state(pre, 2)
    kv_cache.tree_map(lambda d, s: d.copy_(s), gen.cache, pre)
    with _NoHostRead():
        gen.body()


# ----------------------------------------------------------- the reference


def _ref_trace(vocab):
    """Four requests of two prompt lengths (few reference compilations)."""
    rng = np.random.default_rng(5)
    shapes = [(6, 5, 0.0), (9, 4, 0.0), (6, 6, 1.0), (9, 3, 2.0)]
    return [jsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=300 + i)
            for i, (p, n, a) in enumerate(shapes)]


@pytest.mark.parametrize("opts", [dict(slots=2), dict(slots=2, paged=True, block_size=4,
                                                      prefill_chunk=4)],
                         ids=["contiguous", "paged-chunked"])
def test_serve_matches_reference(opts):
    jm, jp, tm, tp = _pair("int_pallas")
    jeng, teng = JEngine(jm, jp, max_new=8), Engine(tm, tp, max_new=8)
    jreqs = _ref_trace(jm.cfg.vocab)
    kw = dict(report_cost=True, **opts)
    jrep = jeng.serve(jreqs, options=JOptions(**kw))
    for r, res in zip(jreqs, jrep.results):        # precondition: reference serve == eager
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len,
                            extra_inputs={"positions": jnp.asarray(_ladder(r.prompt_len))})
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    treqs = [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
             for r in jreqs]
    rep = teng.serve(treqs, ServeOptions(**kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    fields = ("steps", "prefill_tokens", "shared_prefill_tokens", "leaked_blocks",
              "max_prefill_per_step", "cache_len")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}
    if opts.get("paged"):
        assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()


def test_generate_cost_matches_reference():
    jm, jp, tm, tp = _pair("int_pallas")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jm.cfg.vocab, (2, 6)).astype(np.int32)
    pos = _streams(rng, 2, 6, hi=64)
    j = JEngine(jm, jp, max_new=4).generate(prompts, extra_inputs={"positions": jnp.asarray(pos)},
                                            report_cost=True)
    t = Engine(tm, tp, max_new=4).generate(prompts, extra_inputs={"positions": pos},
                                           report_cost=True)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    assert dataclasses.astuple(t.cost) == dataclasses.astuple(j.cost)


def test_reference_rejects_what_the_port_rejects():
    jm, jp, _, _ = _pair("fp")
    jeng, jreqs = JEngine(jm, jp, max_new=4), _ref_trace(jm.cfg.vocab)
    for opts in (dict(slots=2, paged=True, prefix_share=True), dict(slots=2, speculative=True)):
        with pytest.raises(NotImplementedError, match="mrope"):
            jeng.serve(jreqs, options=JOptions(**opts))
