"""Chunked prefill, priority preemption and swap-out/resume in the port
(``Engine.serve``'s ``prefill_chunk`` and ``preemption``), mirroring
``tests/test_chunked_prefill.py`` and ``tests/test_kv_quant.py``.

* The four cache functions of the slice (``slot_scatter``,
  ``slot_prefix_view``, ``swap_read``, ``swap_write``) equal the
  reference's on the same numpy inputs, bitwise, for bf16 and f32 leaves,
  int8 codes with their scales, and MLA latent leaves.
* Inside the port, bitwise (bf16 compute, as ``tests/test_torch_serve.py``):
  a prompt committed in ``prefill_tail`` chunks of 1, 3 or 5 tokens leaves
  the same cache bytes and last logits as one whole prefill (olmo-1b,
  minicpm3-4b, olmo-1b from an int8 cache); a chunked serve gives the
  tokens of the whole-prefill serve and of per-request eager, in both
  layouts, composed with prefix sharing and ``kernel="pallas"``; a
  preempted and resumed stream equals the never-preempted serve and
  per-request eager, plain, with prefix sharing (registered blocks
  re-acquired by key, evicted ones re-prefilled), from an int8 pool and
  for MLA.

``tests/test_torch_chunked_reference.py`` holds the serves against the
reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import kv_cache as jkv
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.scheduler import Request

torch.set_num_threads(2)

# ------------------------------------------------------------ the cache functions

CACHE_KINDS = ["bf16", "f32", "int8", "mla"]
_J_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
            torch.int8: jnp.int8, torch.int32: jnp.int32}


def _kind_cfg(kind):
    arch = "minicpm3-4b" if kind == "mla" else "olmo-1b"
    return dataclasses.replace(tsmoke(arch), kv_quant=kind == "int8")


def _random_like(struct, kind, rng):
    """numpy arrays for every leaf of ``struct`` (meta tensors), with the
    dtype each side should hold: f32 kind keeps its leaves in f32."""
    out = {}
    for k, x in struct.items():
        dt = torch.float32 if kind == "f32" and x.dtype == torch.bfloat16 else x.dtype
        if dt == torch.int8:
            a = rng.integers(-127, 128, tuple(x.shape)).astype(np.int8)
        elif dt == torch.int32:
            a = np.zeros(tuple(x.shape), np.int32)
        else:
            a = rng.standard_normal(tuple(x.shape)).astype(np.float32)
        out[k] = (a, dt)
    return out


def _both(arrays):
    t = {k: torch.from_numpy(a.copy()).to(dt) for k, (a, dt) in arrays.items()}
    j = {k: jnp.asarray(a).astype(_J_DTYPE[dt]) for k, (a, dt) in arrays.items()}
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_tree_equal(t, j):
    assert set(t) == set(j)
    for k in t:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        np.testing.assert_array_equal(_np(t[k]), _np(j[k]), err_msg=k)


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_slot_scatter_and_prefix_view_match_reference(kind):
    cfg = _kind_cfg(kind)
    rng = np.random.default_rng(0)
    tc, jc = _both(_random_like(tkv.cache_zeros(cfg, 3, 16, device="meta"), kind, rng))
    # values as a prefill returns them: [L, 1, T, ...], bf16 leaves cast on write
    vals = _random_like(tkv.cache_zeros(cfg, 1, 9, device="meta"), kind, rng)
    vals = {k: (a, torch.float32 if dt == torch.bfloat16 else dt)
            for k, (a, dt) in vals.items()}
    tv, jv = _both(vals)
    for slot, dst, t0, t1 in [(1, 0, 0, 6), (1, 6, 2, 9), (2, 13, 0, 3)]:
        got = tkv.slot_scatter(tc, tv, slot, dst, t0, t1)
        assert got is tc                           # in place
        jc = jkv.slot_scatter(jc, jv, slot, dst, t0=t0, t1=t1)
        _assert_tree_equal(tc, jc)
    for slot, s in [(1, 13), (2, 16), (0, 1)]:
        view = tkv.slot_prefix_view(tc, slot, s)
        _assert_tree_equal(view, jkv.slot_prefix_view(jc, slot, s))
        before = {k: v.clone() for k, v in view.items()}
        for leaf in tc.values():                   # a copy, not an alias
            leaf[:, slot, :s] = 0
        _assert_tree_equal(view, before)
        for k, leaf in tc.items():                 # back in step with the reference
            leaf.copy_(torch.from_numpy(np.array(_np(jc[k]))).to(leaf.dtype))


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_swap_read_and_write_match_reference(kind):
    cfg = _kind_cfg(kind)
    rng = np.random.default_rng(1)
    struct = tkv.paged_cache_zeros(cfg, 2, 16, 4, 9, device="meta")
    arrays = _random_like(struct, kind, rng)
    arrays["table"] = (np.full(tuple(struct["table"].shape), 9, np.int32), torch.int32)
    arrays["table"][0][:, 1, :3] = [6, 2, 4]
    tc, jc = _both(arrays)
    ids, new_ids = [6, 2, 4], [0, 7, 3]
    row = np.array([5, 0, 7, 3], np.int32)
    payload = tkv.swap_read(tc, 1, ids)
    assert set(payload) == set(tc) - {"table"}
    assert all(v.device.type == "cpu" for v in payload.values())
    jpay = jkv.swap_read(jc, 1, jnp.asarray(ids, jnp.int32))
    _assert_tree_equal(payload, jpay)
    original = {k: v[:, ids].clone() for k, v in tc.items() if k != "table"}
    got = tkv.swap_write(tc, payload, 1, new_ids, row)
    assert got is tc
    jc = jkv.swap_write(jc, jpay, 1, jnp.asarray(new_ids, jnp.int32), jnp.asarray(row))
    _assert_tree_equal(tc, jc)
    for k, v in original.items():                  # the round trip is byte-exact
        assert torch.equal(tc[k][:, new_ids], v), k
    assert (tc["table"][:, 1] == torch.from_numpy(row)).all()
    # nothing private to copy: only the table row changes
    empty = tkv.swap_read(tc, 0, [])
    assert all(v.shape[1] == 0 for v in empty.values())
    row0 = np.array([1, 8, 9, 9], np.int32)
    tkv.swap_write(tc, empty, 0, [], row0)
    jc = jkv.swap_write(jc, jkv.swap_read(jc, 0, jnp.zeros((0,), jnp.int32)), 0,
                        jnp.zeros((0,), jnp.int32), jnp.asarray(row0))
    _assert_tree_equal(tc, jc)


# ------------------------------------------------------------ the model, chunk by chunk

ARCHS = {"olmo-1b": ("olmo-1b", False), "minicpm3-4b": ("minicpm3-4b", False),
         "olmo-1b-int8": ("olmo-1b", True)}
_PORTS = {}


def _port(name):
    if name not in _PORTS:
        arch, quant = ARCHS[name]
        cfg = dataclasses.replace(tsmoke(arch, softmax=SoftmaxSpec("int_pallas")),
                                  kv_quant=quant)
        m = Model(cfg, dtype=torch.bfloat16, device="cpu")
        _PORTS[name] = (m, m.init(torch.Generator().manual_seed(0)))
    return _PORTS[name]


@pytest.mark.parametrize("chunk", [1, 3, 5])
@pytest.mark.parametrize("name", list(ARCHS))
def test_chunked_prefill_commits_the_whole_prefills_bytes(name, chunk):
    """A prompt committed in ``prefill_tail`` chunks (contiguous layout,
    slot 1 of 2, through slot_prefix_view / slot_scatter) holds the bytes
    and gives the last logits of one whole prefill."""
    m, params = _port(name)
    P, C = 11, 16
    x = torch.as_tensor(np.random.default_rng(7).integers(0, m.cfg.vocab, (1, P)))
    logits_w, cache_w = m.prefill(params, {"tokens": x}, cache_len=C)
    committed = tkv.cache_zeros(m.cfg, 2, C, device="cpu")
    c0 = 0
    while c0 < P:
        c1 = min(c0 + chunk, P)
        if c0 == 0:
            logits, piece = m.prefill(params, {"tokens": x[:, :c1]}, cache_len=C)
        else:
            prefix = tkv.slot_prefix_view(committed, 1, c0)
            logits, piece = m.prefill_tail(params, {"tokens": x[:, c0:c1]}, prefix, c0)
        tkv.slot_scatter(committed, piece, 1, c0, 0, c1 - c0)
        c0 = c1
    assert torch.equal(logits[:, -1], logits_w[:, -1])
    assert set(committed) == set(cache_w)
    for k in cache_w:
        assert torch.equal(committed[k][:, 1, :P], cache_w[k][:, 0, :P]), k
        assert not committed[k][:, 0].any(), k      # the other slot untouched


# ------------------------------------------------------------ serving, inside the port


def _trace(vocab, seed=0):
    """tests/test_chunked_prefill.py's mixed trace."""
    rng = np.random.default_rng(seed)
    shapes = [(4, 5, 0.0), (9, 3, 0.0), (12, 4, 1.0), (5, 4, 3.0)]
    return [Request(rid=i, prompt=rng.integers(0, vocab, (p,), dtype=np.int32),
                    max_new=mn, arrival=a, seed=100 + i)
            for i, (p, mn, a) in enumerate(shapes)]


def _shared_trace(vocab, seed=3):
    """tests/test_chunked_prefill.py's shared-prefix trace: the followers
    arrive after the first prompt's last chunk has registered its blocks."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,), dtype=np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [pre, rng.integers(0, vocab, (4,), dtype=np.int32)]),
        max_new=4, arrival=a, seed=200 + i) for i, a in enumerate((0.0, 8.0, 9.0, 10.0))]


def _same_tokens(a, b, ctx=()):
    for x, y in zip(a.results, b.results):
        assert x.rid == y.rid
        np.testing.assert_array_equal(x.tokens, y.tokens, err_msg=str((ctx, x.rid)))
        assert x.done == y.done


def _equals_eager(eng, reqs, rep, ctx=()):
    for r in reqs:
        ref = eng.generate(r.prompt[None], generator=torch.Generator().manual_seed(r.seed),
                           mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        np.testing.assert_array_equal(rep.by_rid()[r.rid].tokens, ref.tokens[0],
                                      err_msg=str((ctx, r.rid)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_chunked_serve_equals_whole_serve(name, paged):
    """Chunks of 1, 7, the block size and more than any prompt: the tokens of
    the whole-prefill serve and of per-request eager, no leaked blocks,
    and at most one chunk of prompt tokens a step."""
    m, params = _port(name)
    eng = Engine(m, params, max_new=6)
    reqs = _trace(m.cfg.vocab)
    kw = dict(slots=2, cache_len=16, paged=paged, block_size=4)
    base = eng.serve(reqs, ServeOptions(**kw))
    _equals_eager(eng, reqs, base)
    for ck in (1, 7, 4, 64):
        rep = eng.serve(reqs, ServeOptions(prefill_chunk=ck, **kw))
        _same_tokens(base, rep, (name, paged, ck))
        assert rep.prefill_chunk == ck and rep.leaked_blocks == 0
        assert rep.max_prefill_per_step <= ck
        assert rep.prefill_tokens == base.prefill_tokens == sum(r.prompt_len for r in reqs)
        if ck == 1:
            assert rep.steps > base.steps or rep.results[-1].first_token_at > \
                base.results[-1].first_token_at


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_chunked_serve_composes_with_prefix_share(name, kernel):
    """Shared-prefix admissions chunk only their private tail: the tokens,
    and the prefill and shared counts, of the whole-prefill serve."""
    m, params = _port(name)
    eng = Engine(m, params, max_new=6)
    reqs = _shared_trace(m.cfg.vocab)
    kw = dict(slots=2, cache_len=16, paged=True, block_size=4, prefix_share=True,
              kernel=kernel)
    base = eng.serve(reqs, ServeOptions(**kw))
    rep = eng.serve(reqs, ServeOptions(prefill_chunk=3, **kw))
    _same_tokens(base, rep, ("share", name, kernel))
    _equals_eager(eng, reqs, rep)
    assert rep.shared_prefill_tokens == base.shared_prefill_tokens > 0
    assert rep.prefill_tokens == base.prefill_tokens
    assert rep.leaked_blocks == 0 and rep.max_prefill_per_step <= 3


def _pressure_trace(vocab, seed=0, prefix=None):
    """tests/test_chunked_prefill.py's priority pressure: two early
    class-1 requests fill a tight pool, a class-0 arrival must preempt.
    ``prefix``: every prompt starts with these 8 tokens."""
    rng = np.random.default_rng(seed)

    def prompt():
        if prefix is None:
            return rng.integers(0, vocab, (12,), dtype=np.int32)
        return np.concatenate([prefix, rng.integers(0, vocab, (4,), dtype=np.int32)])
    reqs = [Request(rid=i, prompt=prompt(), max_new=12, arrival=0.0, seed=300 + i,
                    priority=1) for i in range(2)]
    reqs.append(Request(rid=2, prompt=prompt(), max_new=12, arrival=4.0, seed=302,
                        priority=0))
    return reqs


def _evicting_trace(vocab, seed=2):
    """Prefix sharing under preemption, with eviction: one slot; the class-1
    victim's registered prompt blocks are released on swap-out, and the
    class-0 requests that run meanwhile share its first block (so it stays
    recently used) and evict its other two, so its resume re-acquires the
    first by key and re-prefills the other two."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (4,), dtype=np.int32)

    def prompt():
        return np.concatenate([pre, rng.integers(0, vocab, (8,), dtype=np.int32)])
    victim = Request(rid=0, prompt=prompt(), max_new=12, arrival=0.0, seed=500,
                     priority=1)
    premium = [Request(rid=1 + i, prompt=prompt(), max_new=8, arrival=2.0 + 2 * i,
                       seed=501 + i, priority=0) for i in range(3)]
    return [victim] + premium


PREEMPT_CASES = {
    "plain": ("olmo-1b", dict(num_blocks=16)),
    "share": ("olmo-1b", dict(num_blocks=14, prefix_share=True)),
    "share-evicting": ("olmo-1b", dict(num_blocks=8, prefix_share=True, slots=1)),
    "int8": ("olmo-1b-int8", dict(num_blocks=16)),
    "int8-share-evicting": ("olmo-1b-int8", dict(num_blocks=8, prefix_share=True,
                                                 slots=1)),
    "mla": ("minicpm3-4b", dict(num_blocks=16)),
    "chunked": ("olmo-1b", dict(num_blocks=16, prefill_chunk=5)),
}


def _preempt_trace(case, vocab):
    if "evicting" in case:
        return _evicting_trace(vocab)
    if "share" in case:
        pre = np.random.default_rng(1).integers(0, vocab, (8,), dtype=np.int32)
        return _pressure_trace(vocab, seed=1, prefix=pre)
    return _pressure_trace(vocab)


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("case", list(PREEMPT_CASES))
def test_preempted_streams_equal_never_preempted_and_eager(case, kernel):
    name, extra = PREEMPT_CASES[case]
    m, params = _port(name)
    eng = Engine(m, params, max_new=12)
    reqs = _preempt_trace(case, m.cfg.vocab)
    opts = ServeOptions(**{"slots": 3, "paged": True, "block_size": 4, "kernel": kernel,
                           "preemption": True, **extra})
    rep = eng.serve(reqs, opts)
    assert rep.preemptions >= 1 and rep.resumes == rep.preemptions
    assert sum(r.preempts for r in rep.results) == rep.preemptions
    assert rep.leaked_blocks == 0
    _equals_eager(eng, reqs, rep, (case, kernel))
    calm = eng.serve(reqs, dataclasses.replace(opts, preemption=False,
                                               num_blocks=None))
    assert calm.preemptions == 0
    _same_tokens(calm, rep, (case, kernel))
    lat = {r.rid: r.finished_at for r in rep.results}
    premium = [r for r in rep.results if r.priority == 0]
    assert min(r.first_token_at for r in premium) < max(
        lat[r.rid] for r in rep.results if r.priority == 1)
    if "evicting" in case:
        # a re-prefill rebuilt evicted prompt blocks: prompt tokens were
        # prefilled beyond each prompt's unshared part
        assert rep.evictions > 0
        assert rep.prefill_tokens + rep.shared_prefill_tokens - \
            sum(r.prompt_len for r in reqs) == 8
