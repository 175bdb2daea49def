"""Speculative serving in the port against the reference's, on the same
traces (f32 compute on both sides, the reference's own
``Model.init(PRNGKey(0))`` parameters carried over by
``repro_torch.convert``).

For each trace: greedy tokens; the report's ``steps``, ``drafted_tokens``,
``accepted_tokens`` and ``acceptance_rate``; each request's ``drafted``,
``accepted`` and ``done``; every CostReport (per request, the batch meter,
``cost_draft`` and ``cost_verify``), all equal exactly. Tokens are compared
across frameworks only on traces where the reference's own speculative
serve equals its plain serve (asserted first) and its eager generation
(checked when the seeds were chosen): ROADMAP.md Queue 3's caution.
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
        tm = Model(tcfg, dtype=torch.float32, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[arch, quant] = (JEngine(jm, jp, max_new=10), Engine(tm, tp, max_new=10),
                               jm, jp, tm, tp)
    return _PAIRS[arch, quant]


def _repeating(vocab, seed, n=4):
    """Prompts behind a shared prefix that repeat a motif (n-gram drafts
    are often accepted), a class-0 arrival that preempts a class-1
    request."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,), dtype=np.int32)
    out = []
    for i, (a, pr) in enumerate(((0.0, 1), (0.0, 1), (3.0, 0), (4.0, 1))[:n]):
        motif = rng.integers(0, vocab, (3,), dtype=np.int32)
        out.append(jsch.Request(rid=i, prompt=np.concatenate([pre, np.tile(motif, 3)]),
                                max_new=10, arrival=a, seed=300 + i, priority=pr))
    return out


def _mixed(vocab, seed):
    """tests/test_speculative.py's mixed trace (four requests)."""
    rng = np.random.default_rng(seed)
    shapes = [(4, 6, 0.0), (8, 3, 0.0), (5, 8, 1.0), (4, 2, 3.0)]
    return [jsch.Request(rid=i, prompt=rng.integers(0, vocab, (p,), dtype=np.int32),
                         max_new=mn, arrival=a, seed=100 + i)
            for i, (p, mn, a) in enumerate(shapes)]


PAGED = dict(slots=2, paged=True, block_size=4)
# case -> (arch, int8 pool, trace, options); the seeds are ones on which the
# reference's serves equal its eager
CASES = {
    "contiguous": ("olmo-1b", False, lambda v: _mixed(v, 0), dict(slots=2)),
    "chunked-preempting-share-pallas": ("olmo-1b", False, lambda v: _repeating(v, 3),
                                        dict(prefill_chunk=8, preemption=True, num_blocks=12,
                                             prefix_share=True, kernel="pallas", **PAGED)),
    "mla-pallas": ("minicpm3-4b", False, lambda v: _repeating(v, 3, n=3),
                   dict(kernel="pallas", **PAGED)),
    "self-draft": ("olmo-1b", False, lambda v: _mixed(v, 0), dict(slots=2)),
}


def _port_trace(jreqs):
    return [tsch.Request(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in jreqs]


@pytest.mark.parametrize("case", list(CASES))
def test_spec_serve_matches_reference(case):
    arch, quant, make, kw = CASES[case]
    jeng, teng, jm, jp, tm, tp = _pair(arch, quant)
    jreqs = make(jeng.model.cfg.vocab)
    spec_kw = dict(speculative=True, draft_k=3, report_cost=True)
    tspec = dict(spec_kw)
    if case == "self-draft":
        spec_kw.update(draft="model", draft_model=jm, draft_params=jp)
        tspec.update(draft="model", draft_model=tm, draft_params=tp)
    jrep = jeng.serve(jreqs, options=JOptions(**spec_kw, **kw))
    # precondition: the reference's speculative serve equals its plain
    # serve on this trace (and its plain serve its eager generation, checked
    # on these seeds when they were chosen)
    jplain = jeng.serve(jreqs, options=JOptions(**kw))
    for r, res, base in zip(jreqs, jrep.results, jplain.results):
        assert np.array_equal(res.tokens, base.tokens), ("precondition", r.rid)
    rep = teng.serve(_port_trace(jreqs), ServeOptions(**tspec, **kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert (a.drafted, a.accepted, a.done, a.preempts, a.shared_prefix) == \
            (b.drafted, b.accepted, b.done, b.preempts, b.shared_prefix), a.rid
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    for f in ("cost", "cost_verify", "cost_draft"):
        assert dataclasses.astuple(getattr(rep, f)) == dataclasses.astuple(getattr(jrep, f)), f
    fields = ("steps", "speculative", "draft_k", "drafted_tokens", "accepted_tokens",
              "acceptance_rate", "preemptions", "resumes", "prefill_tokens",
              "shared_prefill_tokens", "leaked_blocks")
    assert {f: getattr(rep, f) for f in fields} == {f: getattr(jrep, f) for f in fields}
    assert rep.drafted_tokens > 0
    if case == "self-draft":
        assert rep.acceptance_rate == 1.0
    if kw.get("preemption"):
        assert rep.preemptions >= 1


def test_verify_step_against_reference():
    """One verify step of the port against the reference's on converted
    weights (f32 compute, contiguous cache after a prefill): logits within
    1e-4 (tier (b): the frameworks' matmuls sum in other orders; the
    decode step's parity tests use the same bound), the same greedy
    targets, and the committed cache within 1e-4."""
    jeng, teng, jm, jp, tm, tp = _pair("olmo-1b", False)
    rng = np.random.default_rng(2)
    b, plen, c, t = 2, 6, 16, 4
    prompts = rng.integers(0, jm.cfg.vocab, (b, plen)).astype(np.int32)
    block = rng.integers(0, jm.cfg.vocab, (b, t)).astype(np.int32)
    pos = np.asarray([plen, plen], np.int32)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, cache_len=c)
    jl, jstaged = jm.verify_step(jp, jcache, {"token": jnp.asarray(block)}, jnp.asarray(pos))
    _, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(prompts, dtype=torch.long)},
                           cache_len=c)
    tl, tstaged = tm.verify_step(tp, tcache, {"token": torch.as_tensor(block, dtype=torch.long)},
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    n = np.asarray([0, 2], np.int32)
    jc = jm.verify_commit(jstaged, jnp.asarray(n), jnp.asarray(pos), t)
    tc = tm.verify_commit(tstaged, torch.from_numpy(n), torch.from_numpy(pos), t)
    for k in tc:
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(jc[k], np.float32),
                                   atol=1e-4, rtol=0, err_msg=k)
