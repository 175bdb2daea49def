"""The port's copies of the serving scheduler, block allocator, traces and
``ServeOptions`` against the reference's, exactly.

* ``BlockAllocator``: a seeded random script of alloc / match_prefix /
  register / writable / release reaches the same ``state_signature`` on both
  sides after every operation;
* ``SlotScheduler``: the same admissions (order, slot, clock) on seeded
  traces, both policies, with and without a resource gate;
* ``prefix_keys`` and every trace generator are byte-equal, and the JSON
  round trip gives the same trace;
* ``ServeOptions`` validates and constructs as the reference does (the
  tensor-parallel ``mesh`` / ``shards`` included), and chunked prefill
  and preemption construct and run through the launcher.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.serving import options as jopt
from repro.serving import scheduler as jsch
from repro_torch.serving import options as topt
from repro_torch.serving import scheduler as tsch


@pytest.mark.parametrize("seed", range(6))
def test_allocator_state_signature_matches_reference(seed):
    rng = np.random.default_rng(seed)
    nb, bs = 12, 4
    ja, ta = jsch.BlockAllocator(nb, bs), tsch.BlockAllocator(nb, bs)
    prompts = [rng.integers(0, 5, (int(rng.integers(4, 20)),), dtype=np.int32)
               for _ in range(6)]
    held = []     # blocks referenced by the script (same ids on both sides)
    for _ in range(200):
        op = int(rng.integers(0, 5))
        if op == 0 and ja.available():
            b = ja.alloc()
            assert ta.alloc() == b
            held.append(b)
        elif op == 1:
            keys = jsch.prefix_keys(prompts[int(rng.integers(len(prompts)))], bs)
            got = ja.match_prefix(keys)
            assert ta.match_prefix(keys) == got
            held += got
        elif op == 2 and held:
            b = held[int(rng.integers(len(held)))]
            key = jsch.prefix_keys(prompts[int(rng.integers(len(prompts)))], bs)
            if key:
                k = key[int(rng.integers(len(key)))]
                if ja.registered(b):
                    continue
                assert ta.register(k, b) == ja.register(k, b)
        elif op == 3 and held and ja.available():
            i = int(rng.integers(len(held)))
            got = ja.writable(held[i])
            assert ta.writable(held[i]) == got
            held[i] = got[0]
        elif op == 4 and held:
            b = held.pop(int(rng.integers(len(held))))
            ja.release_block(b)
            ta.release_block(b)
        assert ta.state_signature() == ja.state_signature()
        assert ta.available() == ja.available()


def _drive(mod, reqs, n_slots, policy, gate):
    """Run a scheduler of module ``mod`` on a fake clock: every step each
    installed slot emits one token; record every admission."""
    budget = {"blocks": 10}

    def admit_ok(r):
        return budget["blocks"] >= 1 + r.max_new // 8

    sched = mod.SlotScheduler(reqs, n_slots, 128, policy=policy,
                              admit_ok=admit_ok if gate else None)
    log, t = [], 0.0
    while sched.unfinished:
        sched.advance(t)
        for slot, req in sched.admit(t):
            log.append((t, slot, req.rid))
            budget["blocks"] -= 1 + req.max_new // 8
            sched.install(slot, 7, False)
        active = sched.active_slots()
        for slot in active:
            sched.slots[slot].generated.append(7)
            if sched.slot_done(slot):
                r = sched.release(slot).request
                budget["blocks"] += 1 + r.max_new // 8
        if not active:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            t = max(t + 1.0, float(nxt))
        else:
            t += 1.0
    return log, sched.admitted_order


@pytest.mark.parametrize("trace", ["random", "poisson"])
@pytest.mark.parametrize("policy,gate", [("continuous", False), ("gang", False),
                                         ("continuous", True)])
def test_admission_order_matches_reference(trace, policy, gate):
    for mod_pair in [(jsch, tsch)]:
        reqs = {}
        for mod in mod_pair:
            if trace == "random":
                reqs[mod] = mod.random_trace(24, 97, seed=5, max_new_range=(2, 20))
            else:
                reqs[mod] = mod.poisson_trace(24, 97, seed=5, rate=0.7,
                                              classes=(0, 1, 2))
        want = _drive(jsch, reqs[jsch], 3, policy, gate)
        got = _drive(tsch, reqs[tsch], 3, policy, gate)
        assert got == want
        assert len(got[1]) == 24


def _same_trace(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x.prompt).tobytes() == np.asarray(y.prompt).tobytes()
        assert (x.rid, x.max_new, x.arrival, x.seed, x.priority, x.deadline) == \
            (y.rid, y.max_new, y.arrival, y.seed, y.priority, y.deadline)


@pytest.mark.parametrize("gen,kw", [
    ("random_trace", dict(seed=3)),
    ("shared_prefix_trace", dict(seed=4, prefix_len=384, suffix_lens=(16, 64, 128),
                                 max_new_range=(16, 64))),
    ("poisson_trace", dict(seed=5, classes=(0, 1), class_weights=(3, 1),
                           deadline_slack=2.0)),
    ("bursty_trace", dict(seed=6)),
])
def test_traces_byte_equal_and_round_trip(gen, kw):
    want = getattr(jsch, gen)(32, 50304, **kw)
    got = getattr(tsch, gen)(32, 50304, **kw)
    _same_trace(got, want)
    data = tsch.trace_to_json(got)
    assert json.dumps(data) == json.dumps(jsch.trace_to_json(want))
    _same_trace(tsch.trace_from_json(json.loads(json.dumps(data))), got)


@pytest.mark.parametrize("p,bs", [(0, 4), (3, 4), (16, 4), (37, 16), (384, 16)])
def test_prefix_keys_byte_equal(p, bs):
    prompt = np.random.default_rng(p).integers(0, 50304, (p,), dtype=np.int32)
    assert tsch.prefix_keys(prompt, bs) == jsch.prefix_keys(prompt, bs)


@pytest.mark.parametrize("kw", [
    dict(slots=0), dict(policy="fifo"), dict(block_size=0),
    dict(prefix_share=True), dict(prefill_chunk=0),
    dict(preemption=True), dict(kernel="pallas"),
    dict(shards=2, mesh=object()), dict(softmax_kind="nope"),
])
def test_serve_options_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jopt.ServeOptions(**kw)
    with pytest.raises(ValueError) as got:
        topt.ServeOptions(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(shards=2), dict(shards=4), dict(mesh="a mesh"),
                                dict(shards=2, paged=True, kernel="pallas")])
def test_mesh_and_shards_options_construct_as_reference(kw):
    """``mesh`` / ``shards`` (tensor-parallel serving) construct as the
    reference's, every field equal; the engine validates the mesh."""
    assert dataclasses.asdict(topt.ServeOptions(**kw)) == \
        dataclasses.asdict(jopt.ServeOptions(**kw))


def test_softmax_kind_option_constructs():
    """``softmax_kind`` (item 12) constructs as the reference's, for every
    name both registries list."""
    from repro_torch.backends import available_backends

    for kind in available_backends():
        opts = topt.ServeOptions(softmax_kind=kind)
        want = jopt.ServeOptions(softmax_kind=kind)
        assert dataclasses.astuple(opts) == dataclasses.astuple(want)


def test_speculative_options_construct():
    opts = topt.ServeOptions(speculative=True, draft_k=3, paged=True)
    want = jopt.ServeOptions(speculative=True, draft_k=3, paged=True)
    assert dataclasses.astuple(opts) == dataclasses.astuple(want)


def test_chunked_prefill_and_preemption_options_construct():
    opts = topt.ServeOptions(paged=True, prefill_chunk=8, preemption=True)
    assert (opts.prefill_chunk, opts.preemption) == (8, True)
    want = jopt.ServeOptions(paged=True, prefill_chunk=8, preemption=True)
    assert dataclasses.astuple(opts) == dataclasses.astuple(want)


def test_launcher_chunked_preempting_serve_prints_sla_line(capsys):
    from repro_torch.launch import serve

    rep = serve.main(["--arch", "olmo-1b", "--smoke", "--continuous", "--paged",
                      "--prefill-chunk", "8", "--preemption", "--softmax", "int_pallas",
                      "--warm-steps", "0", "--device", "cpu", "--requests", "4",
                      "--max-new", "4", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert rep.prefill_chunk == 8 and rep.leaked_blocks == 0
    assert 0 < rep.max_prefill_per_step <= 8
    assert (f"sla: prefill_chunk=8 (max prefill/step {rep.max_prefill_per_step}), "
            f"preemptions=0 resumes=0 leaked_blocks=0") in out
    assert "  class 0: n=4 ttft p50=" in out


def test_launcher_prefill_chunk_requires_continuous(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--arch", "olmo-1b", "--prefill-chunk", "8", "--warm-steps", "0",
                    "--device", "cpu"])
    # the reference's message (src/repro/launch/serve.py)
    assert ("--prefill-chunk requires --continuous (it paces Engine.serve admissions)"
            in capsys.readouterr().err)


def test_serve_options_fields_and_defaults_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(topt.ServeOptions) == fields(jopt.ServeOptions)
    opts = topt.ServeOptions(paged=True, prefix_share=True, kernel="pallas")
    assert dataclasses.replace(opts, kernel="jnp").kernel == "jnp"
