"""One dispatch per decode step (``serving/graphs.py`` and the engine's
fixed-storage decode states), checked on the CPU. The CUDA-graph capture
itself runs only on the card (``chip_smoke.py`` holds graph == op by op
bitwise there); these tests check what makes a step capturable and what
the graph wrapper does around the capture.

* Capture safety: ``Model.decode_step``, the serve step and the fused
  generate step run on ``meta`` parameters, cache, token and positions
  (a 0-d or a [B] position tensor). A host read of a value (``int()``,
  ``.item()``, ``.cpu()``) raises on a meta tensor, so the steps read
  nothing back; the same steps on the CPU dispatch no
  ``_local_scalar_dense`` (the op behind a host read).
* Positions: ``decode_step`` at a 0-d and at a [B] position tensor equals
  the ``int`` path bitwise (logits and cache, contiguous, paged, int8 and
  MLA); ``cache_write`` at a 0-d tensor clamps like the ``int`` path; the
  fused generate (device position, kept cache) equals eager bitwise and
  re-uses its decode state.
* Fixed storage: no cache leaf's storage moves during a chunked,
  preempting serve (bf16, int8, MLA), and the next serve re-uses it.
* Re-used cache: two serves on one engine give equal reports, equal to a
  fresh engine's, and the reset cache equals ``*_cache_zeros``.
* Launch counters count launches only: nothing under capture
  (``kernels.count_launch``); ``StepGraph`` over stub CUDA calls warms up,
  captures once, counts its replays and refuses moved storage; the
  garbage collector is held off inside the capture.
* Prefill products on the card are padded to ``PREFILL_MIN_ROWS`` rows
  (chunked == whole there); the padded product equals the plain one.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import smoke_config
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.kernels import count_launch
from repro_torch.models import kv_cache
from repro_torch.models.attention import cache_write
from repro_torch.models.layers import Ctx, dense_apply
from repro_torch.models.model import PREFILL_MIN_ROWS, Model
from repro_torch.serving import graphs
from repro_torch.serving.engine import Engine, _to_meta
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.scheduler import Request

torch.set_num_threads(2)

ARCHS = {"olmo-1b": ("olmo-1b", False), "olmo-1b-int8": ("olmo-1b", True),
         "minicpm3-4b": ("minicpm3-4b", False)}
_PORTS = {}


def _port(name):
    if name not in _PORTS:
        arch, quant = ARCHS[name]
        cfg = dataclasses.replace(smoke_config(arch, softmax=SoftmaxSpec("int_pallas")),
                                  kv_quant=quant)
        m = Model(cfg, dtype=torch.bfloat16, device="cpu")
        _PORTS[name] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS[name]


class _NoHostRead(TorchDispatchMode):
    """Fails on the op behind ``int()`` / ``.item()`` of a tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor value back to the host")
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------------ capture safety

META_CASES = {
    "olmo-1b contiguous": ("olmo-1b", None),
    "olmo-1b paged bf16": ("olmo-1b", (4, 12)),
    "olmo-1b paged int8": ("olmo-1b-int8", (4, 12)),
    "minicpm3-4b paged": ("minicpm3-4b", (4, 12)),
}


def test_meta_tensors_refuse_host_reads():
    """The control: what the meta checks below rely on."""
    x = torch.zeros((), dtype=torch.int32, device="meta")
    for read in (int, lambda t: t.item(), lambda t: t.cpu()):
        with pytest.raises(Exception):
            read(x)


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("case", list(META_CASES))
def test_decode_and_serve_steps_run_on_meta(case, kernel):
    name, geom = META_CASES[case]
    if kernel == "pallas" and geom is None:
        pytest.skip("kernel='pallas' decodes the paged layout only")
    m, params = _port(name)
    cfg = m.cfg
    if kernel == "pallas":
        cfg = cfg.with_softmax(dataclasses.replace(cfg.softmax, kind="int_pallas_paged"))
    meta = Model(cfg, dtype=torch.bfloat16, device="meta")
    mparams = _to_meta(params)
    slots, C = 3, 16
    tok = torch.zeros((slots, 1), dtype=torch.long, device="meta")
    for pos in (torch.zeros((), dtype=torch.int32, device="meta"),
                torch.zeros((slots,), dtype=torch.int32, device="meta")):
        if geom is None:
            cache = kv_cache.cache_zeros(cfg, slots, C, device="meta")
        else:
            cache = kv_cache.paged_cache_zeros(cfg, slots, C, *geom, device="meta")
        logits, out = meta.decode_step(mparams, cache, {"token": tok}, pos)
        assert logits.shape == (slots, 1, cfg.vocab) and logits.device.type == "meta"
        assert out is cache
    # the serve step the engine replays, greedy (sampled inside: tokens and
    # flags beside the last logits) and with a sampler that draws (the step
    # returns the last logits)
    for sampler, kw in (("greedy", {}), ("temperature", {"temp": 0.7})):
        eng = Engine(Model(m.cfg, dtype=torch.bfloat16, device="meta"), mparams,
                     sampler=sampler, eos_id=3, **kw)
        st = eng._serve_state(kernel, slots, C, geom)
        assert st.cache[next(iter(st.cache))].device.type == "meta"
        out = st.body()
        if sampler == "greedy":
            out, last = out
            assert tuple(last.shape) == (slots, m.cfg.vocab)
        want = (2, slots) if sampler == "greedy" else (slots, m.cfg.vocab)
        assert tuple(out.shape) == want and st.draws == (sampler != "greedy")


@pytest.mark.parametrize("name", list(ARCHS))
def test_generate_step_runs_on_meta(name):
    m, params = _port(name)
    eng = Engine(Model(m.cfg, dtype=torch.bfloat16, device="meta"), _to_meta(params),
                 eos_id=3)
    st = eng._generate_state(kv_cache.cache_zeros(m.cfg, 2, 16, device="meta"), 2)
    new, last = st.body()
    assert new.shape == (2,) and last.shape == (2, m.cfg.vocab)
    assert [b.device.type for b in st.buffers] == ["meta"] * 3


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_steps_read_nothing_back_on_the_cpu(name, kernel):
    """The real serve and generate steps on the CPU dispatch no host read."""
    m, params = _port(name)
    eng = Engine(m, params, max_new=4, eos_id=5)
    st = eng._serve_state(kernel, 2, 16, (4, 10))
    st.buffers[0].copy_(torch.tensor([[7, 9], [0, 16], [0, 1]]))   # slot 1 parked
    with _NoHostRead():
        st.body()
    gen = eng._generate_state(kv_cache.cache_zeros(m.cfg, 2, 16, device="cpu"), 2)
    with _NoHostRead():
        gen.body()


# ----------------------------------------------------------------------- positions


def _paged_from(cfg, cache, bs=4):
    """The contiguous cache [L, B, C, ...] copied into a paged pool: row b's
    logical block j in physical block b * n + j."""
    _, b, c = next(iter(cache.values())).shape[:3]
    n = c // bs
    pool = kv_cache.paged_cache_zeros(cfg, b, c, bs, b * n, device="cpu")
    for i in range(b):
        row = np.arange(i * n, (i + 1) * n, dtype=np.int32)
        w = np.arange(c)
        kv_cache.paged_scatter(pool, {k: v[:, i:i + 1] for k, v in cache.items()}, i, row,
                               row[w // bs], w % bs, 0, c)
    return pool


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_step_tensor_positions_equal_int(name, layout):
    m, params = _port(name)
    b, p, C = 3, 6, 12
    prompts = torch.as_tensor(np.random.default_rng(4).integers(0, m.cfg.vocab, (b, p)))
    _, cache0 = m.prefill(params, {"tokens": prompts}, cache_len=C)
    if layout == "paged":
        cache0 = _paged_from(m.cfg, cache0)
    tok = prompts[:, -1:]
    outs = []
    for pos in (p, torch.tensor(p, dtype=torch.int32), torch.full((b,), p, dtype=torch.int32)):
        cache = {k: v.clone() for k, v in cache0.items()}
        logits, cache = m.decode_step(params, cache, {"token": tok}, pos)
        outs.append((logits, cache))
    for logits, cache in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for k in cache:
            assert torch.equal(cache[k], outs[0][1][k]), k
    assert not torch.equal(outs[0][1][next(iter(cache0))], cache0[next(iter(cache0))])


def test_cache_write_device_position_clamps_like_int():
    buf0 = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    new = -torch.ones((2, 2, 3))
    for pos in (-3, 0, 5, 6, 7, 12):
        a = cache_write(buf0.clone(), new, pos)
        b = cache_write(buf0.clone(), new, torch.tensor(pos))
        assert torch.equal(a, b), pos


@pytest.mark.parametrize("sampler,kw,eos", [("greedy", {}, None), ("greedy", {}, "first"),
                                            ("temperature", {"temp": 0.8}, "first")])
@pytest.mark.parametrize("name", list(ARCHS))
def test_fused_generate_equals_eager_and_reuses_its_state(name, sampler, kw, eos):
    m, params = _port(name)
    prompts = np.random.default_rng(2).integers(0, m.cfg.vocab, (2, 5)).astype(np.int32)
    eos_id = None
    if eos == "first":
        eos_id = int(Engine(m, params, max_new=1).generate(prompts).tokens[0, -1])
    eng = Engine(m, params, max_new=6, sampler=sampler, eos_id=eos_id, **kw)
    runs = [eng.generate(prompts, generator=torch.Generator().manual_seed(3), mode=mode)
            for mode in ("fused", "eager", "fused")]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.tokens, runs[0].tokens)
        assert torch.equal(r.logits, runs[0].logits)
        if eos_id is not None:
            np.testing.assert_array_equal(r.done, runs[0].done)
    assert len(eng._decode_states) == 1          # one state for the shape, re-used
    (st,) = eng._decode_states.values()
    assert st.draws == (sampler != "greedy")


# ------------------------------------------------------------- fixed storage, reuse


def _pressure_trace(vocab, seed=0):
    """Two class-1 requests fill a tight pool; a class-0 arrival preempts."""
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, (12,), dtype=np.int32),
                    max_new=12, arrival=0.0, seed=300 + i, priority=1) for i in range(2)]
    reqs.append(Request(rid=2, prompt=rng.integers(0, vocab, (12,), dtype=np.int32),
                        max_new=12, arrival=4.0, seed=302, priority=0))
    return reqs


def _storage(cache):
    return {k: (v.untyped_storage().data_ptr(), v.data_ptr()) for k, v in cache.items()}


PREEMPT_OPTIONS = dict(slots=3, paged=True, block_size=4, num_blocks=16, preemption=True,
                       prefill_chunk=5)


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_cache_storage_fixed_across_a_chunked_preempting_serve(name, kernel, monkeypatch):
    m, params = _port(name)
    eng = Engine(m, params, max_new=12)
    reqs = _pressure_trace(m.cfg.vocab)
    opts = ServeOptions(kernel=kernel, **PREEMPT_OPTIONS)
    seen = []
    decode = Engine._serve_decode

    def spy(self, st, host, gens):
        seen.append((id(st.cache), _storage(st.cache)))
        return decode(self, st, host, gens)

    monkeypatch.setattr(Engine, "_serve_decode", spy)
    rep = eng.serve(reqs, opts)
    assert rep.preemptions >= 1 and rep.resumes == rep.preemptions
    assert rep.prefill_chunk == 5 and rep.leaked_blocks == 0
    (st,) = eng._decode_states.values()
    assert len(seen) == rep.steps
    assert all(s == (id(st.cache), _storage(st.cache)) for s in seen)
    seen.clear()
    again = eng.serve(reqs, opts)        # the next serve re-uses the storage
    assert len(eng._decode_states) == 1
    assert all(s == (id(st.cache), _storage(st.cache)) for s in seen) and seen
    for a, b in zip(rep.results, again.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _report_signature(rep):
    """The report without its host-clock fields."""
    clock = {"wall_s", "latency_s", "ttft_s", "tbt_s", "class_latency"}
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name not in clock | {"results"}}
    out["results"] = [{f.name: (getattr(r, f.name).tolist() if f.name == "tokens"
                                else getattr(r, f.name))
                       for f in dataclasses.fields(r) if f.name not in clock}
                      for r in rep.results]
    return out


REUSE_CASES = {
    "contiguous": ("olmo-1b", dict(slots=2, cache_len=24)),
    "paged+share": ("olmo-1b", dict(slots=2, paged=True, block_size=4, prefix_share=True,
                                    kernel="pallas")),
    "int8 chunked+preempting": ("olmo-1b-int8", PREEMPT_OPTIONS),
    "mla chunked+preempting": ("minicpm3-4b", dict(PREEMPT_OPTIONS, kernel="pallas")),
}


@pytest.mark.parametrize("case", list(REUSE_CASES))
def test_reused_cache_serves_equal_a_fresh_engine(case):
    name, kw = REUSE_CASES[case]
    m, params = _port(name)
    reqs = _pressure_trace(m.cfg.vocab, seed=5)
    opts = ServeOptions(report_cost=True, **kw)
    eng = Engine(m, params, max_new=12, eos_id=11)
    first, second = eng.serve(reqs, opts), eng.serve(reqs, opts)
    fresh = Engine(m, params, max_new=12, eos_id=11).serve(reqs, opts)
    assert _report_signature(first) == _report_signature(second) == _report_signature(fresh)
    (st,) = eng._decode_states.values()
    assert any(bool(v.ne(0).any()) for k, v in st.cache.items() if k != "table")
    st.reset_cache()
    if opts.paged:
        num_blocks = st.cache["k" if "k" in st.cache else "c_kv"].shape[1]
        want = kv_cache.paged_cache_zeros(m.cfg, opts.slots, first.cache_len, opts.block_size,
                                          num_blocks, device="cpu")
    else:
        want = kv_cache.cache_zeros(m.cfg, opts.slots, first.cache_len, device="cpu")
    assert set(want) == set(st.cache)
    for k in want:
        assert st.cache[k].dtype == want[k].dtype and torch.equal(st.cache[k], want[k]), k


# ---------------------------------------------------------------- launch counters


class _Counted:
    def __call__(self):
        pass


@pytest.mark.parametrize("capturing", [False, True])
def test_count_launch_counts_launches_not_captures(capturing, monkeypatch):
    """A wrapper's call under CUDA-graph capture launches nothing, so its
    count stays; outside capture each call adds one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    k = _Counted()
    k.launches, k.int8_launches = 5, 2
    for _ in range(3):
        count_launch(k)
    count_launch(k, "int8_launches")
    assert (k.launches, k.int8_launches) == ((5, 2) if capturing else (8, 3))


class _StubGraph:
    replays = 0

    def replay(self):
        _StubGraph.replays += 1


def test_step_graph_over_stub_cuda_calls(monkeypatch):
    """StepGraph's flow with the CUDA calls stubbed: the first call is the
    warm-up step (its result returned) and the capture; each later call
    replays, counts the replay and returns the captured output; a fixed
    tensor whose storage moved raises."""
    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    buf = torch.zeros(4)
    calls = []

    def body():
        calls.append(1)
        return torch.full((1,), float(len(calls)))

    g = graphs.StepGraph(body, [buf])
    first = g()
    assert float(first) == 1.0 and len(calls) == 2        # warm-up, then capture
    assert g.replays == 0 and _StubGraph.replays == 0
    for _ in range(3):
        out = g()
    assert out is g.out and float(out) == 2.0              # the captured output
    assert len(calls) == 2 and g.replays == 3 == _StubGraph.replays
    g.fixed[0] = torch.zeros(4)                            # storage moved
    with pytest.raises(RuntimeError, match="moved"):
        g()
    assert g.replays == 3


def test_step_graph_captures_with_the_collector_held_off(monkeypatch):
    """The garbage collector does not run inside a capture (a dead cycle
    holding an earlier graph would be destroyed there and invalidate it):
    it is off while the step is captured, on for the warm-up and after the
    capture, also after one that raised."""
    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    seen = []

    def body(fail=False):
        seen.append(gc.isenabled())
        if fail and len(seen) == 2:
            raise RuntimeError("capture failed")
        return torch.zeros(1)

    assert gc.isenabled()
    graphs.StepGraph(body, [])()
    assert seen == [True, False] and gc.isenabled()
    seen.clear()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.StepGraph(lambda: body(fail=True), [])()
    assert seen == [True, False] and gc.isenabled()


# ------------------------------------------------------------ prefill row padding


@pytest.mark.parametrize("shape,bias", [((1, 5, 6), False), ((3, 4, 6), True),
                                        ((2, 300, 6), False)])
def test_dense_apply_pads_rows_exactly(shape, bias):
    """Zero rows added to a product change none of its rows: integer
    values in f64, so every sum is exact and the check is bitwise."""
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-8, 9, shape, generator=g).to(torch.float64)
    p = {"w": torch.randint(-8, 9, (6, 7), generator=g).to(torch.float64)}
    if bias:
        p["b"] = torch.arange(7, dtype=torch.float64)
    plain = dense_apply(p, x, Ctx(dtype=torch.float64))
    padded = dense_apply(p, x, Ctx(dtype=torch.float64, min_rows=PREFILL_MIN_ROWS))
    assert padded.shape == plain.shape == shape[:-1] + (7,)
    assert torch.equal(padded, plain)


@pytest.mark.parametrize("device", ["cpu", "meta", "cuda"])
def test_prefill_ctx_pads_on_the_card_only(device, monkeypatch):
    """The prefill's products are padded on the card (where cuBLAS's
    split-K depends on the row count); the CPU, the meta meter and the
    decode step keep their rows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    m = Model(smoke_config("olmo-1b"), device=device)
    assert m.ctx.min_rows == 0
    assert m.prefill_ctx.min_rows == (PREFILL_MIN_ROWS if device == "cuda" else 0)
    assert m.prefill_ctx.dtype == m.ctx.dtype
