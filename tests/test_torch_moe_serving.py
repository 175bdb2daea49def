"""MoE serving in the port (dbrx-132b and deepseek-v2-236b smoke configs:
4 experts, top-2, deepseek-v2 with its dense prefix layer, MLA and a shared
expert) through ``Engine.serve``.

The reference's capacity is per routing group (one sequence) and per call,
so a prompt routed whole, in chunks or as a tail after a shared prefix can
drop different assignments, and so can a verify block against its decode
steps: in the reference itself shared == private, chunked == whole and
spec == plain hold for MoE only where nothing drops (ROADMAP.md Queue 3).
The traces below are built so that nothing can drop at smoke width (every
routing group of 4 or 8 tokens, where the capacity is 4 or 8 slots an
expert; a verify block of 4 tokens), and each test first counts the
dropped assignments of its runs and asserts there are none.

* Inside the port, bitwise (bf16 compute): serve == eager (contiguous,
  paged, paged with ``kernel="pallas"``); shared == private (tokens and
  every logit row); chunked (``prefill_chunk=4``) == whole; speculative
  (n-gram drafts of 3) == plain (tokens).
* Against the reference (f32 compute, the reference's own parameters
  through ``repro_torch.convert``): greedy tokens, allocator state,
  counters and CostReports equal exactly, on a drop-free trace where the
  reference's serve equals its eager (asserted first), and on a trace whose
  prefills drop assignments (asserted), where the port must drop what the
  reference drops.
* ``python -m repro_torch.launch.serve --arch dbrx-132b`` serves.
"""

import contextlib
import dataclasses

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
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

ARCHS = ["dbrx-132b", "deepseek-v2-236b"]
_PORTS = {}


def _port(arch):
    if arch not in _PORTS:
        cfg = tsmoke(arch, softmax=SoftmaxSpec("int_pallas"))
        m = Model(cfg, dtype=torch.bfloat16, device="cpu")
        _PORTS[arch] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS[arch]


@contextlib.contextmanager
def _drops():
    """Counts the dropped assignments of every routing call inside (the
    engine's meter runs on meta tensors and is skipped)."""
    n = [0]
    route = moe._route

    def counted(p, x, cfg, ctx):
        out = route(p, x, cfg, ctx)
        if x.device.type != "meta":
            n[0] += int((out[1] == cfg.n_experts * out[0]).sum())
        return out

    moe._route = counted
    try:
        yield n
    finally:
        moe._route = route


def _trace(vocab, seed, n=5):
    """A shared 4-token prefix and 4-token suffixes (prompts of 8 tokens,
    tails of 4): every routing group holds 4 or 8 tokens, so no expert can
    take more than its capacity."""
    return tsch.shared_prefix_trace(n, vocab, prefix_len=4, seed=seed, suffix_lens=(4,),
                                    max_new_range=(4, 7), arrival_spacing=1.0)


class _Rows:
    """Greedy sampler keeping every logits row it samples, by request seed."""

    def __init__(self):
        self.rows = {}

    def __call__(self, logits, generator):
        self.rows.setdefault(generator.initial_seed(), []).append(logits[0].clone())
        return torch.argmax(logits, dim=-1).to(torch.int32)


def _serve(m, params, reqs, record=True, **kw):
    """Serve ``reqs`` with nothing dropped; (report, logit rows by request
    seed, or None when not ``record``: the speculative verifier needs the
    registry's greedy sampler)."""
    rec = _Rows() if record else None
    eng = Engine(m, params, max_new=8, **({"sampler": rec} if record else {}))
    with _drops() as n:
        rep = eng.serve(reqs, ServeOptions(cache_len=16, **kw))
    assert n[0] == 0, f"{n[0]} assignments dropped"
    assert rep.leaked_blocks == 0
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
    reqs = _trace(m.cfg.vocab, seed=1)
    paged = dict(paged=True, block_size=4) if layout == "paged" else {}
    rep, _ = _serve(m, params, reqs, slots=2, kernel=kernel, **paged)
    eng = Engine(m, params, max_new=8)
    for r in reqs:
        with _drops() as n:
            ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                               mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        assert n[0] == 0
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str(r.rid))


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shared_equals_private_and_chunked_equals_whole(arch, kernel):
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=2)
    kw = dict(slots=2, paged=True, block_size=4, kernel=kernel)
    private = _serve(m, params, reqs, **kw)
    shared = _serve(m, params, reqs, prefix_share=True, **kw)
    assert shared[0].shared_prefill_tokens > 0
    _same(shared, private)
    chunked = _serve(m, params, reqs, prefix_share=True, prefill_chunk=4, **kw)
    assert chunked[0].max_prefill_per_step <= 4
    _same(chunked, private)


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_equals_plain(arch):
    """Drafts of 3: a verify block holds 4 tokens, at most the capacity of
    4, so it never drops; every request's tokens equal the plain serve's."""
    m, params = _port(arch)
    reqs = _trace(m.cfg.vocab, seed=3)
    kw = dict(slots=2, paged=True, block_size=4, prefix_share=True, kernel="pallas")
    plain = _serve(m, params, reqs, record=False, **kw)
    spec = _serve(m, params, reqs, record=False, speculative=True, draft_k=3, **kw)
    assert spec[0].speculative and spec[0].drafted_tokens > 0
    _same(spec, plain)


# ------------------------------------------------------------------ the reference


_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        jm = JModel(jsmoke(arch, softmax=JSpec("int_pallas")), dtype=jnp.float32)
        jp = jm.init_split(jax.random.PRNGKey(0))[0]
        tcfg = tsmoke(arch, softmax=SoftmaxSpec("int_pallas"))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[arch] = (JEngine(jm, jp, max_new=8),
                        Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp, max_new=8))
    return _PAIRS[arch]


def _port_trace(jreqs):
    return [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in jreqs]


# case -> (trace, options, dropping); "drops": prompts of 12-16 tokens behind a
# 10-token prefix, whose whole and tail prefills drop assignments
CASES = {
    "drop-free, shared, pallas": (
        # seed 3: on seeds 1, 2, 4 and 5 (dbrx) and 6 (deepseek-v2) of this
        # trace the reference's serve differs from its own eager (ROADMAP.md's caution)
        lambda v: jsch.shared_prefix_trace(4, v, prefix_len=4, seed=3, suffix_lens=(4,),
                                           max_new_range=(4, 6), arrival_spacing=1.0),
        dict(slots=2, cache_len=16, paged=True, block_size=4, prefix_share=True,
             kernel="pallas"), False),
    "drops, shared, chunked": (
        lambda v: jsch.shared_prefix_trace(4, v, prefix_len=10, seed=4, suffix_lens=(2, 6),
                                           max_new_range=(4, 6), arrival_spacing=1.0),
        dict(slots=2, cache_len=24, paged=True, block_size=4, prefix_share=True,
             prefill_chunk=6), True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch, case):
    make, kw, dropping = CASES[case]
    jeng, teng = _pair(arch)
    jreqs = make(jeng.model.cfg.vocab)
    jrep = jeng.serve(jreqs, options=JOptions(report_cost=True, **kw))
    if not dropping:
        # precondition: the reference's serve equals its own eager here
        for r, res in zip(jreqs, jrep.results):
            ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                                max_new=r.max_new, cache_len=jrep.cache_len)
            assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    with _drops() as n:
        rep = teng.serve(_port_trace(jreqs), ServeOptions(report_cost=True, **kw))
    assert (n[0] > 0) == dropping, n[0]
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid and a.shared_prefix == b.shared_prefix
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    fields = ("steps", "prefill_tokens", "shared_prefill_tokens", "leaked_blocks",
              "max_prefill_per_step", "cow_copies")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_cpu(arch):
    from repro_torch.launch import serve

    rep = serve.main(["--arch", arch, "--smoke", "--continuous", "--paged",
                      "--prefix-share", "--kernel", "pallas", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--requests", "3",
                      "--max-new", "4"])
    assert len(rep.results) == 3 and rep.paged and rep.leaked_blocks == 0
    assert rep.cost.backend == "int_pallas" and rep.cost.cycles > 0
