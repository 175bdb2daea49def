"""Chunked prefill and preemption in the port's ``Engine.serve`` against the
reference's, on the same traces (f32 compute on both sides, the
reference's own ``Model.init(PRNGKey(0))`` parameters carried over by
``repro_torch.convert``).

For each trace: greedy tokens; the allocator's ``state_signature``; the
report's ``steps``, ``preemptions``, ``resumes``, ``prefill_chunk``,
``max_prefill_per_step``, ``prefill_tokens``, ``shared_prefill_tokens``,
``evictions`` and ``leaked_blocks``; each request's ``admitted_at``,
``first_token_at``, ``finished_at``, ``preempts`` and ``shared_prefix``;
and every CostReport (per request and batch), all equal exactly. Tokens
are compared across frameworks only on traces where the reference's own
serve equals its eager (asserted first: ROADMAP.md Queue 3's caution).
"""

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
from repro_torch.models.model import Model
from repro_torch.serving import scheduler as tsch
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions

torch.set_num_threads(2)

_PAIRS = {}


def _pair(arch, quant):
    """(reference engine, port engine) at smoke width, f32, int_pallas."""
    if (arch, quant) not in _PAIRS:
        jcfg = dataclasses.replace(jsmoke(arch, softmax=JSpec("int_pallas")), kv_quant=quant)
        tcfg = dataclasses.replace(tsmoke(arch, softmax=SoftmaxSpec("int_pallas")),
                                   kv_quant=quant)
        jm = JModel(jcfg, dtype=jnp.float32)
        jp = jm.init_split(jax.random.PRNGKey(0))[0]
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[arch, quant] = (JEngine(jm, jp, max_new=12),
                               Engine(Model(tcfg, dtype=torch.float32, device="cpu"), tp,
                                      max_new=12))
    return _PAIRS[arch, quant]


def _mixed(vocab, seed):
    """tests/test_chunked_prefill.py's mixed trace."""
    rng = np.random.default_rng(seed)
    shapes = [(4, 5, 0.0), (9, 3, 0.0), (12, 4, 1.0), (5, 4, 3.0)]
    return [jsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,), dtype=np.int32),
                         max_new=mn, arrival=a, seed=100 + i)
            for i, (p, mn, a) in enumerate(shapes)]


def _shared(vocab, seed):
    """tests/test_chunked_prefill.py's shared-prefix trace."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,), dtype=np.int32)
    return [jsch.Request(rid=i, prompt=np.concatenate(
        [pre, rng.integers(0, vocab, (4,), dtype=np.int32)]),
        max_new=4, arrival=a, seed=200 + i) for i, a in enumerate((0.0, 8.0, 9.0, 10.0))]


def _pressure(vocab, seed, share=False):
    """tests/test_chunked_prefill.py's priority pressure (and, ``share``,
    its prefix-sharing variant): two class-1 requests, then a class-0
    arrival that must preempt one."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,), dtype=np.int32) if share else None

    def prompt():
        if pre is None:
            return rng.integers(0, vocab, (12,), dtype=np.int32)
        return np.concatenate([pre, rng.integers(0, vocab, (4,), dtype=np.int32)])
    return [jsch.Request(rid=i, prompt=prompt(), max_new=12, arrival=a, seed=300 + i,
                         priority=p) for i, (a, p) in enumerate(((0.0, 1), (0.0, 1),
                                                                 (4.0, 0)))]


def _evicting(vocab, seed):
    """One slot, a class-1 victim and three class-0 arrivals sharing its
    first block: the victim's resume re-acquires that block by key and
    re-prefills the two evicted ones."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (4,), dtype=np.int32)

    def prompt():
        return np.concatenate([pre, rng.integers(0, vocab, (8,), dtype=np.int32)])
    return [jsch.Request(rid=i, prompt=prompt(), max_new=12 if i == 0 else 8,
                         arrival=0.0 if i == 0 else 2.0 * i, seed=500 + i,
                         priority=0 if i else 1) for i in range(4)]


PAGED = dict(slots=2, cache_len=16, paged=True, block_size=4)
PRESSURE = dict(slots=3, paged=True, block_size=4, preemption=True)
# case -> (arch, int8 pool, trace, options); the seeds are ones on which the
# reference's serve equals its eager
CASES = {
    "chunk-contiguous": ("olmo-1b", False, lambda v: _mixed(v, 0),
                         dict(slots=2, cache_len=16, prefill_chunk=3)),
    "chunk-paged": ("olmo-1b", False, lambda v: _mixed(v, 0),
                    dict(prefill_chunk=1, **PAGED)),
    "chunk-share-pallas": ("olmo-1b", False, lambda v: _shared(v, 7),
                           dict(prefill_chunk=3, prefix_share=True, kernel="pallas",
                                **PAGED)),
    "preempt": ("olmo-1b", False, lambda v: _pressure(v, 3),
                dict(num_blocks=16, **PRESSURE)),
    "preempt-share": ("olmo-1b", False, lambda v: _pressure(v, 1, share=True),
                      dict(num_blocks=14, prefix_share=True, **PRESSURE)),
    "preempt-evicting-chunked": ("olmo-1b", False, lambda v: _evicting(v, 1),
                                 dict(num_blocks=8, prefix_share=True, prefill_chunk=5,
                                      **dict(PRESSURE, slots=1))),
    "preempt-int8-pallas": ("olmo-1b", True, lambda v: _pressure(v, 4),
                            dict(num_blocks=16, kernel="pallas", **PRESSURE)),
    "mla-chunk-preempt": ("minicpm3-4b", False, lambda v: _pressure(v, 0),
                          dict(num_blocks=16, prefill_chunk=5, **PRESSURE)),
}


def _port_trace(jreqs):
    return [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in jreqs]


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_and_preempting_serve_match_reference(case):
    arch, quant, make, kw = CASES[case]
    jeng, teng = _pair(arch, quant)
    jreqs = make(jeng.model.cfg.vocab)
    jrep = jeng.serve(jreqs, options=JOptions(report_cost=True, **kw))
    # precondition: the reference's own serve equals its eager on this trace
    for r, res in zip(jreqs, jrep.results):
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed), mode="eager",
                            max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    rep = teng.serve(_port_trace(jreqs), ServeOptions(report_cost=True, **kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert (a.admitted_at, a.first_token_at, a.finished_at, a.preempts,
                a.shared_prefix, a.done) == \
            (b.admitted_at, b.first_token_at, b.finished_at, b.preempts,
             b.shared_prefix, b.done), a.rid
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    fields = ("steps", "cache_len", "preemptions", "resumes", "prefill_chunk",
              "max_prefill_per_step", "prefill_tokens", "shared_prefill_tokens",
              "cow_copies", "evictions", "leaked_blocks")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}
    if kw.get("paged"):
        assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    if kw.get("preemption"):
        assert rep.preemptions >= 1
    if "evicting" in case:
        assert rep.evictions > 0 and rep.prefill_tokens + rep.shared_prefill_tokens > \
            sum(r.prompt_len for r in jreqs)
