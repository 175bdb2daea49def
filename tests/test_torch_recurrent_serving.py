"""Serving the recurrent families in the port (mamba2-780m and hymba-1.5b
smoke configs) through ``Engine.serve``.

* Inside the port, bitwise (bf16 compute): serve == per-request eager
  generate (contiguous, paged, paged with ``kernel="pallas"``: K2's and
  K1's plain versions); staged chunked prefill (the budget accrues, then
  one whole prefill) == whole, every logit row; preempted and resumed ==
  never preempted, every logit row; greedy speculative (n-gram drafts) ==
  plain; ``prefix_share=True`` shares nothing (SSM state and rings
  summarise the whole prefix).
* Against the reference (f32 compute, the reference's own parameters
  through ``repro_torch.convert``), on a trace where the reference's serve
  equals its own eager (asserted first): greedy tokens, allocator state,
  counters and CostReports equal exactly, paged and chunked.
* The hybrid serve from an int8 pool raises in the port, and the
  reference's serve fails on the same call (its int8 window rings and
  the bf16 rings its prefill builds disagree).
* The steps the card captures (serve step, verify round, fused generate
  step) read nothing back to the host; the engine's kept (nested) cache
  keeps its storage across serves and resets to ``paged_cache_zeros``
  (ring positions -1).
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
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

ARCHS = ["mamba2-780m", "hymba-1.5b"]
_PORTS = {}


def _port(arch):
    if arch not in _PORTS:
        m = Model(tsmoke(arch, softmax=SoftmaxSpec("int_pallas")), device="cpu")
        _PORTS[arch] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS[arch]


def _trace(vocab, seed=0, classes=False):
    """Six requests: prompts of 6 to 32 tokens (up to the smoke window and
    SSD chunk of 32), staggered arrivals; ``classes``: every third request
    in class 0, the rest in class 1."""
    rng = np.random.default_rng(seed)
    shapes = [(12, 6, 0.0), (32, 5, 0.0), (6, 8, 1.0), (20, 4, 2.0), (9, 7, 3.0), (16, 6, 3.0)]
    return [tsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=100 + i,
                         priority=(0 if classes and i % 3 == 2 else 1 if classes else 0))
            for i, (p, n, a) in enumerate(shapes)]


class _Rows:
    """Greedy sampler keeping every logits row it samples, by request seed."""

    def __init__(self):
        self.rows = {}

    def __call__(self, logits, generator):
        self.rows.setdefault(generator.initial_seed(), []).append(logits[0].clone())
        return torch.argmax(logits, dim=-1).to(torch.int32)


def _serve(m, params, reqs, record=True, **kw):
    rec = _Rows() if record else None
    eng = Engine(m, params, max_new=8, **({"sampler": rec} if record else {}))
    rep = eng.serve(reqs, ServeOptions(**kw))
    assert rep.leaked_blocks == 0 and rep.shared_prefill_tokens == 0
    return rep, rec.rows if record else None


def _same(a, b):
    (ra, rows_a), (rb, rows_b) = a, b
    for x, y in zip(ra.results, rb.results):
        np.testing.assert_array_equal(x.tokens, y.tokens, err_msg=str(x.rid))
    if rows_a is None or rows_b is None:
        return
    assert set(rows_a) == set(rows_b)
    for s in rows_a:
        assert len(rows_a[s]) == len(rows_b[s])
        assert all(torch.equal(u, v) for u, v in zip(rows_a[s], rows_b[s])), s


@pytest.mark.parametrize("layout,kernel", [("contiguous", "jnp"), ("paged", "jnp"),
                                           ("paged", "pallas")])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_equals_eager(arch, layout, kernel):
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab)
    paged = dict(paged=True, block_size=8) if layout == "paged" else {}
    rep, _ = _serve(m, params, reqs, slots=3, kernel=kernel, prefix_share=bool(paged),
                    **paged)
    if m.cfg.family == "hybrid":
        assert rep.cache_len >= m.cfg.window
    eng = Engine(m, params, max_new=8)
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str(r.rid))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_staged_chunked_equals_whole(arch, paged):
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=1)
    kw = dict(slots=3, paged=True, block_size=8) if paged else dict(slots=3)
    whole = _serve(m, params, reqs, **kw)
    chunked = _serve(m, params, reqs, prefill_chunk=8, **kw)
    assert chunked[0].prefill_chunk == 8
    # the staged branch prefills whole: a prompt of P tokens waits its
    # budget, then goes in one step
    assert chunked[0].max_prefill_per_step == max(r.prompt_len for r in reqs)
    _same(chunked, whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_equals_never_preempted(arch):
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=2, classes=True)
    kw = dict(slots=2, paged=True, block_size=8, kernel="pallas")
    plain = _serve(m, params, reqs, **kw)
    pre = _serve(m, params, reqs, preemption=True, prefill_chunk=16, num_blocks=10, **kw)
    assert pre[0].preemptions >= 1 and pre[0].resumes == pre[0].preemptions
    _same(pre, plain)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_spec_equals_plain(arch, paged):
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=3)
    kw = dict(slots=3, paged=True, block_size=8, kernel="pallas") if paged else dict(slots=3)
    plain = _serve(m, params, reqs, record=False, **kw)
    spec = _serve(m, params, reqs, record=False, speculative=True, draft_k=3, **kw)
    assert spec[0].speculative and spec[0].drafted_tokens > 0
    _same(spec, plain)


# ------------------------------------------------------------------ the reference

_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        jm = JModel(jsmoke(arch, softmax=JSpec("int_pallas")), dtype=jnp.float32)
        jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
        tcfg = tsmoke(arch, softmax=SoftmaxSpec("int_pallas"))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[arch] = (JEngine(jm, jp, max_new=8),
                        Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp, max_new=8))
    return _PAIRS[arch]


def _ref_trace(vocab):
    """Four requests of two prompt lengths (few reference compilations).
    Seed 8: on seed 7 the reference's mamba2 serve differs from its own
    eager at a step (ROADMAP.md Queue 3's caution)."""
    rng = np.random.default_rng(8)
    shapes = [(12, 5, 0.0), (20, 4, 0.0), (12, 6, 1.0), (20, 3, 2.0)]
    return [jsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                         max_new=n, arrival=a, seed=200 + i)
            for i, (p, n, a) in enumerate(shapes)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    jeng, teng = _pair(arch)
    jreqs = _ref_trace(jeng.model.cfg.vocab)
    kw = dict(slots=2, paged=True, block_size=8, prefix_share=True, prefill_chunk=16,
              report_cost=True)
    jrep = jeng.serve(jreqs, options=JOptions(**kw))
    for r, res in zip(jreqs, jrep.results):       # precondition: reference serve == eager
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    treqs = [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
             for r in jreqs]
    rep = teng.serve(treqs, ServeOptions(**kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid and a.shared_prefix == b.shared_prefix == 0
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    fields = ("steps", "prefill_tokens", "shared_prefill_tokens", "leaked_blocks",
              "max_prefill_per_step", "cow_copies", "cache_len")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}


@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_int8_serve_raises_as_the_reference_fails(paged):
    jcfg = dataclasses.replace(jsmoke("hymba-1.5b"), kv_quant=True)
    jm = JModel(jcfg)
    jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
    jreqs = _ref_trace(jcfg.vocab)[:2]
    kw = dict(slots=2, paged=paged, block_size=8)
    with pytest.raises((ValueError, KeyError)):
        JEngine(jm, jp, max_new=8).serve(jreqs, options=JOptions(**kw))
    tcfg = dataclasses.replace(tsmoke("hymba-1.5b"), kv_quant=True)
    m = Model(tcfg, device="cpu")
    eng = Engine(m, m.init(torch.Generator().manual_seed(0)), max_new=8)
    treqs = [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
             for r in jreqs]
    with pytest.raises(ValueError, match="int8 pool"):
        eng.serve(treqs, ServeOptions(**kw))
    # generate runs, with bf16 rings beside the int8 global layers
    res = eng.generate(treqs[0].prompt[None], mode="eager", max_new=3)
    assert res.tokens.shape == (1, treqs[0].prompt_len + 3)


# -------------------------------------------- fixed storage and capture safety


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on the op behind ``int()`` / ``.item()`` of a tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor value back to the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_read_nothing_back(arch):
    """The serve step, the verify round (verify step, verifier, snapshot
    select) and the fused generate step on the CPU dispatch no host read:
    each can be captured as a CUDA graph on the card."""
    from repro_torch.models import kv_cache

    m, params = _port(arch)
    eng = Engine(m, params, max_new=4, eos_id=5)
    c = max(32, m.cfg.window) if m.cfg.family == "hybrid" else 32
    st = eng._serve_state("pallas", 2, c, (8, 10))
    st.buffers[0].copy_(torch.tensor([[7, 9], [0, c], [0, 1]]))   # slot 1 parked
    with _NoHostRead():
        st.body()
    sp = eng._spec_state("pallas", 2, c, (8, 10), 3)
    sp.buffers[0].copy_(torch.tensor([[7, 1, 2, 3, 4], [9, 4, 4, 4, c]]))
    with _NoHostRead():
        sp.body()
    _, pre = m.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.long)}, cache_len=16)
    gen = eng._generate_state(pre, 2)
    kv_cache.tree_map(lambda d, s: d.copy_(s), gen.cache, pre)
    with _NoHostRead():
        gen.body()


@pytest.mark.parametrize("arch", ARCHS)
def test_kept_cache_resets_to_zeros_and_serves_as_fresh(arch):
    """The engine's kept cache (nested for the hybrid) keeps its storage
    across a chunked, preempting serve and the next one, whose report
    equals a fresh engine's; ``reset_cache`` gives ``paged_cache_zeros``:
    zeros, the sentinel table, ring positions -1."""
    from repro_torch.models import kv_cache

    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=2, classes=True)
    opts = ServeOptions(slots=2, paged=True, block_size=8, kernel="pallas", preemption=True,
                        prefill_chunk=16, num_blocks=10)
    eng = Engine(m, params, max_new=8)
    first = eng.serve(reqs, opts)
    (st,) = eng._decode_states.values()
    ptrs = [v.data_ptr() for v in kv_cache.tree_leaves(st.cache)]
    second = eng.serve(reqs, opts)
    fresh = Engine(m, params, max_new=8).serve(reqs, opts)
    assert [v.data_ptr() for v in kv_cache.tree_leaves(st.cache)] == ptrs
    assert first.preemptions >= 1
    for a, b, c in zip(first.results, second.results, fresh.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, c.tokens)
    st.reset_cache()
    want = kv_cache.paged_cache_zeros(m.cfg, 2, first.cache_len, 8, 10)
    for (got, w) in zip(kv_cache.tree_leaves(st.cache), kv_cache.tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w)
