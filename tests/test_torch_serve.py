"""The port's ``Engine.serve``: continuous batching, the paged pool, prefix
sharing and the fused paged decode.

* Inside the port, bitwise (bf16 compute, where the CPU's matrix products
  give the same row whatever the batch): every served request equals
  ``Engine.generate(mode="eager")`` of it alone with its own seed and the
  serve's cache length — for the contiguous, paged and paged + shared
  layouts with the gather (``jnp``) and fused (``pallas``) kernels, the
  ``gang`` policy, a temperature sampler with per-request seeds, and an EOS
  early exit that pads like eager.
* Against the reference (f32 compute on both sides, the reference's own
  ``Model.init(PRNGKey(0))`` parameters): greedy tokens equal the
  reference's ``serve`` on traces where the reference's serve equals its
  eager (asserted first — ROADMAP.md's caution: on this jax the reference's
  olmo-1b serve and eager differ on some traces); the allocator's
  ``state_signature``, prefill/shared token counts, copy-on-write copies and
  evictions are equal; per-request and batch CostReports are equal exactly.
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

LAYOUTS = {
    "contiguous": dict(),
    "paged": dict(paged=True, block_size=4),
    "paged+share": dict(paged=True, block_size=4, prefix_share=True),
}


@pytest.fixture(scope="module")
def port():
    cfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _trace(vocab, n=6, seed=1):
    return tsch.shared_prefix_trace(n, vocab, prefix_len=9, seed=seed,
                                    suffix_lens=(2, 4, 7), max_new_range=(4, 7),
                                    arrival_spacing=1.0)


def _assert_serve_equals_eager(eng, reqs, rep):
    assert [r.rid for r in rep.results] == sorted(r.rid for r in reqs)
    for r in reqs:
        res = rep.by_rid()[r.rid]
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(res.tokens, ref.tokens[0], err_msg=str(r.rid))
        if eng.eos_id is not None:
            assert res.done == bool(ref.done[0])


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serve_equals_eager(port, layout, kernel):
    if kernel == "pallas" and not LAYOUTS[layout]:
        pytest.skip("kernel='pallas' needs the paged layout (ServeOptions rejects it)")
    m, params = port
    eng = Engine(m, params, max_new=8)
    reqs = _trace(m.cfg.vocab)
    rep = eng.serve(reqs, ServeOptions(slots=2, cache_len=32, kernel=kernel,
                                       **LAYOUTS[layout]))
    _assert_serve_equals_eager(eng, reqs, rep)
    assert rep.leaked_blocks == 0
    if layout == "paged+share":
        assert rep.shared_prefill_tokens > 0
        assert rep.prefill_tokens + rep.shared_prefill_tokens == \
            sum(r.prompt_len for r in reqs)


@pytest.mark.parametrize("policy,sampler", [("gang", "greedy"),
                                            ("continuous", "temperature")])
def test_serve_equals_eager_gang_and_stochastic(port, policy, sampler):
    """``gang`` admits whole batches; a temperature sampler draws each
    request's numbers from its own seeded generator, as eager does."""
    m, params = port
    kw = {"temp": 1.3, "top_k": 40} if sampler == "temperature" else {}
    eng = Engine(m, params, max_new=8, sampler=sampler, **kw)
    reqs = _trace(m.cfg.vocab, n=5, seed=2)
    rep = eng.serve(reqs, ServeOptions(slots=3, cache_len=32, policy=policy,
                                       paged=True, block_size=4, prefix_share=True,
                                       kernel="pallas"))
    _assert_serve_equals_eager(eng, reqs, rep)


def test_copy_on_write_and_eos_early_exit(port):
    """An identical twin prompt shares all its blocks and copies the
    boundary block on its forced tail write; a request hitting EOS frees its
    slot and pads like eager."""
    m, params = port
    rng = np.random.default_rng(3)
    common = rng.integers(0, m.cfg.vocab, (8,), dtype=np.int32)
    probe = Engine(m, params, max_new=3).generate(common[None], mode="eager")
    eos = int(probe.tokens[0, -2])          # the twin's second token is EOS
    reqs = [tsch.Request(rid=0, prompt=common.copy(), max_new=6, seed=11),
            tsch.Request(rid=1, prompt=common.copy(), max_new=6, seed=22),
            tsch.Request(rid=2, prompt=rng.integers(0, m.cfg.vocab, (5,), dtype=np.int32),
                         max_new=6, arrival=1.0, seed=33)]
    eng = Engine(m, params, max_new=6, eos_id=eos)
    rep = eng.serve(reqs, ServeOptions(slots=3, cache_len=20, paged=True, block_size=4,
                                       prefix_share=True, kernel="pallas"))
    _assert_serve_equals_eager(eng, reqs, rep)
    assert rep.cow_copies >= 1 and rep.by_rid()[1].shared_prefix == 7
    assert rep.by_rid()[0].done
    assert (rep.by_rid()[0].tokens[10:] == eos).all()


def test_kernel_pallas_rejects_a_float_softmax(port):
    m, params = port
    fp = Model(m.cfg.with_softmax(SoftmaxSpec("fp")), dtype=torch.bfloat16, device="cpu")
    eng = Engine(fp, params, max_new=4)
    with pytest.raises(ValueError, match="not an Alg.-1 dataflow"):
        eng.serve(_trace(m.cfg.vocab, n=2), ServeOptions(paged=True, kernel="pallas"))


# ------------------------------------------------------------ against the reference


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke("olmo-1b", softmax=JSpec("int_pallas"))
    tcfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jm.init_split(jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
    return JEngine(jm, jp, max_new=8), Engine(Model(tcfg, dtype=torch.float32,
                                                    device="cpu"), tp, max_new=8)


def _twins(vocab, seed):
    """Two identical 8-token prompts and a longer one sharing them."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, vocab, (8,), dtype=np.int32)
    longer = np.concatenate([p, rng.integers(0, vocab, (3,), dtype=np.int32)])
    return [jsch.Request(rid=i, prompt=q.copy(), max_new=6, arrival=a, seed=s)
            for i, (q, a, s) in enumerate([(p, 0.0, 11), (p, 0.0, 22), (longer, 1.0, 33)])]


def _port_trace(jreqs):
    return [tsch.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                         arrival=r.arrival, seed=r.seed) for r in jreqs]


CASES = {
    # the shared-prefix workload: 2 slots, sharing, no pool pressure
    "share": (lambda v: jsch.shared_prefix_trace(
        6, v, prefix_len=9, seed=4, suffix_lens=(2, 4, 7), max_new_range=(4, 6),
        arrival_spacing=1.0),
        dict(slots=2, cache_len=32, paged=True, block_size=4, prefix_share=True)),
    # a pool with no slack: cached blocks are evicted, admissions deferred
    "pressure": (lambda v: jsch.shared_prefix_trace(
        8, v, prefix_len=8, seed=1, suffix_lens=(4, 8), max_new_range=(4, 6),
        arrival_spacing=0.0),
        dict(slots=2, cache_len=24, paged=True, block_size=4, num_blocks=10,
             prefix_share=True)),
    # twins sharing every block: copy-on-write at the boundary
    "cow": (lambda v: _twins(v, seed=0),
            dict(slots=3, cache_len=20, paged=True, block_size=4, prefix_share=True)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
def test_serve_matches_reference(pair, case, kernel):
    jeng, teng = pair
    make, kw = CASES[case]
    jreqs = make(jeng.model.cfg.vocab)
    jrep = jeng.serve(jreqs, options=JOptions(kernel=kernel, report_cost=True, **kw))
    # precondition: the reference's own serve equals its eager on this trace
    for r, res in zip(jreqs, jrep.results):
        ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed),
                            mode="eager", max_new=r.max_new, cache_len=jrep.cache_len)
        assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
    rep = teng.serve(_port_trace(jreqs), ServeOptions(kernel=kernel, report_cost=True,
                                                      **kw))
    for a, b in zip(rep.results, jrep.results):
        assert a.rid == b.rid and a.shared_prefix == b.shared_prefix
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
        assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost), a.rid
    assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)
    assert teng._last_alloc.state_signature() == jeng._last_alloc.state_signature()
    assert (rep.steps, rep.cache_len, rep.prefill_tokens, rep.shared_prefill_tokens,
            rep.cow_copies, rep.evictions, rep.leaked_blocks) == \
        (jrep.steps, jrep.cache_len, jrep.prefill_tokens, jrep.shared_prefill_tokens,
         jrep.cow_copies, jrep.evictions, jrep.leaked_blocks)
    if case == "cow":
        assert rep.cow_copies >= 1
    if case == "pressure":
        assert rep.evictions > 0


def test_contiguous_serve_matches_reference(pair):
    """The contiguous layout on the reference's own random trace, gang and
    continuous, with the cost meter."""
    jeng, teng = pair
    jreqs = jsch.random_trace(6, jeng.model.cfg.vocab, seed=0, prompt_lens=(4, 8),
                              max_new_range=(3, 8), arrival_spacing=1.0)
    for policy in ("continuous", "gang"):
        jrep = jeng.serve(jreqs, options=JOptions(slots=2, policy=policy,
                                                  report_cost=True))
        for r, res in zip(jreqs, jrep.results):
            ref = jeng.generate(r.prompt[None], key=jax.random.PRNGKey(r.seed),
                                mode="eager", max_new=r.max_new,
                                cache_len=jrep.cache_len)
            assert np.array_equal(res.tokens, ref.tokens[0]), ("precondition", r.rid)
        rep = teng.serve(_port_trace(jreqs), ServeOptions(slots=2, policy=policy,
                                                          report_cost=True))
        assert rep.steps == jrep.steps
        for a, b in zip(rep.results, jrep.results):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert dataclasses.astuple(a.cost) == dataclasses.astuple(b.cost)
        assert dataclasses.astuple(rep.cost) == dataclasses.astuple(jrep.cost)


def test_launcher_continuous_route_on_cpu():
    from repro_torch.launch import serve

    rep = serve.main(["--arch", "olmo-1b", "--smoke", "--continuous", "--paged",
                      "--prefix-share", "--kernel", "pallas", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--requests", "4",
                      "--max-new", "4"])
    assert len(rep.results) == 4 and rep.paged and rep.leaked_blocks == 0
    assert rep.cost.backend == "int_pallas" and rep.cost.cycles > 0
    with pytest.raises(SystemExit):        # --kernel pallas needs --paged
        serve.main(["--arch", "olmo-1b", "--continuous", "--kernel", "pallas",
                    "--warm-steps", "0", "--device", "cpu"])
