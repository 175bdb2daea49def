"""Speculative decoding in the port (``Model.verify_step`` /
``verify_commit``, ``kv_cache.commit_staged``, ``make_spec_verifier``,
``serving/speculative.py`` and ``Engine.serve(speculative=True)``),
mirroring ``tests/test_speculative.py``.

* Against the reference on the same numpy inputs, bitwise:
  ``ngram_propose`` and ``_NgramIndex``; ``cache_write_block``,
  ``paged_write_block``, ``verify_mask`` and ``commit_staged`` (contiguous
  bf16 / f32, int8 codes with their scales, MLA latents, paged through the
  table; parked slots at ``cache_len``, over-draft tails, sentinel
  entries); the greedy verifier's ``out`` / ``n_emit`` on the same logits;
  the error messages for a callable sampler and a recurrent draft model.
* Inside the port, bitwise (bf16 compute): a T-token ``verify_step``
  equals T sequential ``decode_step`` calls (logits; the cache committed
  at full acceptance) and a fully rejected round leaves the cache of one
  decode step — no drafted K/V behind — for olmo-1b, llama2-7b and
  minicpm3-4b, contiguous, paged, int8 and ``kernel="pallas"`` (K2's and
  K4's plain versions); greedy speculative serve equals plain serve on the
  paged, prefix-shared, int8, pallas, chunked, preempting and EOS paths;
  a draft model that is the target accepts every draft.
* The stochastic verifier's first emission follows the analytic target
  distribution (a frequency test), whatever the draft.
* The verify round runs without a host read (capturable on the card).

``tests/test_torch_speculative_reference.py`` holds the serves against the
reference's.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro.models import attention as jatt
from repro.models import kv_cache as jkv
from repro.serving import sampler as jsampler
from repro.serving import speculative as jspec
from repro_torch.configs.registry import smoke_config
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import attention as tatt
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import Model
from repro_torch.serving import sampler as tsampler
from repro_torch.serving import speculative as tspec
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.scheduler import Request

torch.set_num_threads(2)

_J_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
            torch.int8: jnp.int8, torch.int32: jnp.int32}


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


# ------------------------------------------------------------------ proposers


def test_ngram_propose_and_index_match_reference():
    """Seeded streams over small vocabularies (many hits): the port's
    ``ngram_propose`` equals the reference's at every prefix, and the
    incremental ``_NgramIndex`` equals both."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        vocab, k, n = (3, 6, 9)[trial % 3], 1 + trial % 4, 1 + trial % 3
        seq = rng.integers(0, vocab, (50,), dtype=np.int32)
        idx = tspec._NgramIndex(max_ngram=n)
        idx.extend(seq[:2])
        for i in range(2, len(seq)):
            want = jspec.ngram_propose(seq[:i], k, max_ngram=n)
            assert tspec.ngram_propose(seq[:i], k, max_ngram=n).tolist() == want.tolist()
            assert idx.propose(k).tolist() == want.tolist(), (trial, i)
            idx.extend([seq[i]])
    assert tspec.ngram_propose(np.asarray([1, 2, 3], np.int32), 2).tolist() == [3, 3]


def test_ngram_proposer_parks_inactive_slots():
    p = tspec.NgramProposer(k=2)
    p.begin(slots=3, cache_len=16)
    p.admit(1, np.asarray([4, 4], np.int32), 4, 2)
    out = p.propose([1], np.zeros((3, 1), np.int32), np.zeros((3,), np.int32))
    assert out.shape == (3, 2) and out[1].tolist() == [4, 4] and out[0].tolist() == [0, 0]
    assert p.meter_round() is None


# ----------------------------------------------------- the cache functions

CACHE_KINDS = ["bf16", "f32", "int8", "mla"]


def _kind_cfg(kind):
    arch = "minicpm3-4b" if kind == "mla" else "olmo-1b"
    return dataclasses.replace(smoke_config(arch), kv_quant=kind == "int8")


def _random_tree(struct, kind, rng):
    """(torch leaves, jax leaves) of random contents shaped like ``struct``
    (meta tensors); the f32 kind keeps its float leaves in f32."""
    t, j = {}, {}
    for k, x in struct.items():
        dt = torch.float32 if kind == "f32" and x.dtype == torch.bfloat16 else x.dtype
        if k == "table":
            continue
        if dt == torch.int8:
            a = rng.integers(-127, 128, tuple(x.shape)).astype(np.int8)
        else:
            a = rng.standard_normal(tuple(x.shape)).astype(np.float32)
        t[k] = torch.from_numpy(a.copy()).to(dt)
        j[k] = jnp.asarray(a).astype(_J_DTYPE[dt])
    return t, j


def _table(nb, slots, n_log, rng):
    """Private blocks per slot in shuffled order, the last entries of each
    row sentinels."""
    ids = rng.permutation(nb)[:slots * (n_log - 1)].reshape(slots, n_log - 1)
    return np.concatenate([ids, np.full((slots, 1), nb)], 1).astype(np.int32)


# per-row start positions: in range, an over-draft tail past the end of the
# cache (or into the sentinel block), and a parked slot at cache_len
C, BS, T = 16, 4, 3
POS = np.asarray([5, 14, 16], np.int32)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_block_writes_match_reference(kind, paged):
    cfg = _kind_cfg(kind)
    rng = np.random.default_rng(3)
    b = len(POS)
    nb = b * (C // BS) + 2
    struct = (tkv.paged_cache_zeros(cfg, b, C, BS, nb, device="meta") if paged
              else tkv.cache_zeros(cfg, b, C, device="meta"))
    t_leaves, j_leaves = _random_tree({k: v[0] for k, v in struct.items()}, kind, rng)
    new_t, new_j = _random_tree({k: torch.empty((b, T) + tuple(v.shape[3:]), dtype=v.dtype,
                                                device="meta")
                                 for k, v in struct.items() if k != "table"}, kind, rng)
    table = _table(nb, b, C // BS, rng)
    for k in t_leaves:
        if paged:
            got = tatt.paged_write_block(t_leaves[k], torch.from_numpy(table), new_t[k],
                                         torch.from_numpy(POS))
            want = jatt.paged_write_block(j_leaves[k], jnp.asarray(table), new_j[k],
                                          jnp.asarray(POS))
        else:
            got = tatt.cache_write_block(t_leaves[k], new_t[k], torch.from_numpy(POS))
            want = jatt.cache_write_block(j_leaves[k], new_j[k], jnp.asarray(POS))
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=k)


@pytest.mark.parametrize("cache_pos", [5, 14])
def test_block_writes_take_an_int_position(cache_pos):
    """An int position writes what the same position as a [B] tensor
    writes, in both layouts (over-draft entries past the cache drop)."""
    rng = np.random.default_rng(4)
    buf = torch.from_numpy(rng.standard_normal((2, C, 3)).astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((9, BS, 3)).astype(np.float32))
    table = torch.from_numpy(_table(8, 2, C // BS, rng))
    new = torch.from_numpy(rng.standard_normal((2, T, 3)).astype(np.float32))
    pos = torch.full((2,), cache_pos, dtype=torch.int32)
    assert torch.equal(tatt.cache_write_block(buf.clone(), new, cache_pos),
                       tatt.cache_write_block(buf.clone(), new, pos))
    assert torch.equal(tatt.paged_write_block(pool.clone(), table, new, cache_pos),
                       tatt.paged_write_block(pool.clone(), table, new, pos))


@pytest.mark.parametrize("window", [0, 3])
def test_verify_mask_matches_reference(window):
    q = np.asarray([[2, 3, 4], [14, 15, 16]], np.int32)
    got = tatt.verify_mask(C, torch.from_numpy(q), window)
    want = jatt.verify_mask(C, jnp.asarray(q), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_commit_staged_matches_reference(kind, paged):
    """Rejected tails cleared to zero at every accepted depth (0, 1 and
    full), contiguous or through the table, every layer; parked slots and
    over-draft positions drop."""
    cfg = _kind_cfg(kind)
    rng = np.random.default_rng(5)
    b = len(POS)
    nb = b * (C // BS) + 2
    struct = (tkv.paged_cache_zeros(cfg, b, C, BS, nb, device="meta") if paged
              else tkv.cache_zeros(cfg, b, C, device="meta"))
    t_leaves, j_leaves = _random_tree(struct, kind, rng)
    if paged:
        table = np.broadcast_to(_table(nb, b, C // BS, rng), struct["table"].shape).copy()
        t_leaves["table"] = torch.from_numpy(table)
        j_leaves["table"] = jnp.asarray(table)
    for n_acc in ([0, 1, 2], [2, 0, 1], [1, 2, 0]):
        n = np.asarray(n_acc, np.int32)
        got = tkv.commit_staged({k: v.clone() for k, v in t_leaves.items()},
                                torch.from_numpy(n), torch.from_numpy(POS), T)
        want = jkv.commit_staged(dict(j_leaves), jnp.asarray(n), jnp.asarray(POS), T)
        for k in t_leaves:
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=f"{k} {n_acc}")


def test_commit_staged_refuses_recurrent_snapshots():
    """The recurrent branch (SSM state / conv tail, a window ring: per-token
    snapshots [L, T, B, ...]) selects, per row, the snapshot after the last
    accepted token, bitwise as the reference's, and copies it into the
    cache when one is given."""
    rng = np.random.default_rng(5)
    L, T, B = 2, 3, 3
    staged = {"ssm": {"state": rng.normal(size=(L, T, B, 2, 4, 4)).astype(np.float32),
                      "conv": rng.normal(size=(L, T, B, 3, 6)).astype(np.float32)},
              "attn": {"k": rng.normal(size=(L, T, B, 8, 2, 4)).astype(np.float32),
                       "pos": rng.integers(-1, 40, size=(L, T, B, 8)).astype(np.int32)}}
    n = np.asarray([2, 0, 1], np.int32)
    want = jkv.commit_staged(jax.tree.map(jnp.asarray, staged), jnp.asarray(n),
                             jnp.asarray(POS), T)
    t_staged = jax.tree.map(torch.from_numpy, staged)
    got = tkv.commit_staged(t_staged, torch.from_numpy(n), torch.from_numpy(POS), T)
    cache = jax.tree.map(lambda a: torch.zeros(a.shape[:1] + a.shape[2:],
                                               dtype=torch.from_numpy(a).dtype), staged)
    into = tkv.commit_staged(t_staged, torch.from_numpy(n), torch.from_numpy(POS), T,
                             into=cache)
    assert into is cache
    for path in (("ssm", "state"), ("ssm", "conv"), ("attn", "k"), ("attn", "pos")):
        w = np.asarray(want[path[0]][path[1]])
        np.testing.assert_array_equal(_np(got[path[0]][path[1]]), w, err_msg=str(path))
        np.testing.assert_array_equal(_np(cache[path[0]][path[1]]), w, err_msg=str(path))


# ----------------------------------------------------- model-level oracles

MODEL_CASES = {
    "olmo-1b contiguous": ("olmo-1b", False, False, "int_pallas"),
    "olmo-1b int8": ("olmo-1b", True, False, "int_pallas"),
    "olmo-1b paged": ("olmo-1b", False, True, "int_pallas"),
    "olmo-1b pallas": ("olmo-1b", False, True, "int_pallas_paged"),
    "olmo-1b int8 pallas": ("olmo-1b", True, True, "int_pallas_paged"),
    "llama2-7b paged": ("llama2-7b", False, True, "int_pallas"),
    "minicpm3-4b contiguous": ("minicpm3-4b", False, False, "int_pallas"),
    "minicpm3-4b pallas": ("minicpm3-4b", False, True, "int_pallas_paged"),
}
_MODELS = {}


def _model(arch, quant, kind, dtype=torch.bfloat16):
    key = (arch, quant, kind, dtype)
    if key not in _MODELS:
        cfg = dataclasses.replace(smoke_config(arch, softmax=SoftmaxSpec(kind)),
                                  kv_quant=quant)
        m = Model(cfg, dtype=dtype, device="cpu")
        _MODELS[key] = (m, m.init(torch.Generator().manual_seed(0)))
    return _MODELS[key]


def _paged_install(cfg, cache, b, c, bs):
    """Each row's prefill entries into private blocks of a fresh pool."""
    n_log = c // bs
    pool = tkv.paged_cache_zeros(cfg, b, c, bs, b * n_log + 1)
    for row in range(b):
        ids = torch.arange(row * n_log + 1, (row + 1) * n_log + 1)   # block 0 unused
        pool["table"][:, row] = ids.to(torch.int32)
        for k, leaf in pool.items():
            if k != "table":
                v = cache[k][:, row]
                leaf[:, ids] = v.reshape((v.shape[0], n_log, bs) + tuple(v.shape[2:])).to(
                    leaf.dtype)
    return pool


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_verify_step_matches_sequential_decode(case):
    """One T-token verify pass == T decode steps, bitwise: the logits, the
    cache committed at full acceptance, and at full rejection the cache of
    the first token's decode step alone (no drafted K/V survives)."""
    arch, quant, paged, kind = MODEL_CASES[case]
    m, p = _model(arch, quant, kind)
    b, plen, c, t, bs = 2, 5, 16, 4, 4
    rng = np.random.default_rng(1)
    logits, cache = m.prefill(p, {"tokens": torch.as_tensor(
        rng.integers(0, m.cfg.vocab, (b, plen)))}, cache_len=c)
    if paged:
        cache = _paged_install(m.cfg, cache, b, c, bs)
    pos = torch.tensor([plen, plen + 2], dtype=torch.int32)   # rows at their own offsets
    toks = [torch.argmax(logits[:, -1], -1)[:, None]]
    seq, seq_logits = _clone(cache), []
    for i in range(t):
        lg, seq = m.decode_step(p, seq, {"token": toks[-1]}, pos + i)
        seq_logits.append(lg[:, 0])
        toks.append(torch.argmax(lg[:, -1], -1)[:, None])
    v_logits, staged = m.verify_step(p, _clone(cache), {"token": torch.cat(toks[:t], 1)}, pos)
    assert torch.equal(v_logits, torch.stack(seq_logits, 1))
    full = m.verify_commit(_clone(staged), torch.full((b,), t - 1), pos, t)
    assert all(torch.equal(full[k], seq[k]) for k in seq)
    _, one = m.decode_step(p, _clone(cache), {"token": toks[0]}, pos)
    none = m.verify_commit(_clone(staged), torch.zeros((b,), dtype=torch.int32), pos, t)
    assert all(torch.equal(none[k], one[k]) for k in one)


# --------------------------------------------------------------- verifiers


def test_greedy_verifier_matches_reference():
    """On the same logits (ties and all), the batched greedy verifier gives
    the reference's per-slot ``out`` / ``n_emit``; hand-built cases pin
    accept-all, reject-first and reject-middle."""
    rng = np.random.default_rng(0)
    s, t, v = 6, 4, 9
    logits = rng.integers(-3, 3, (s, t, v)).astype(np.float32)   # ties
    targets = np.argmax(logits, -1)
    drafts = np.where(rng.random((s, t - 1)) < 0.7, targets[:, :-1],
                      rng.integers(0, v, (s, t - 1))).astype(np.int32)
    drafts[0] = targets[0, :-1]
    out, n = tsampler.make_spec_verifier("greedy", pad_id=7)(
        torch.from_numpy(logits), torch.from_numpy(drafts), None)
    jverify = jsampler.make_spec_verifier("greedy", pad_id=7)
    for i in range(s):
        jo, jn, _ = jverify(jnp.asarray(logits[i]), jnp.asarray(drafts[i]),
                            jax.random.PRNGKey(0))
        assert out[i].tolist() == np.asarray(jo).tolist() and int(n[i]) == int(jn), i
    assert int(n[0]) == t


def test_stochastic_verifier_distribution():
    """Rejection sampling against p = softmax(masked logits): the first
    emitted token's frequencies over many generators match p within
    binomial noise, whether the draft is p's likeliest token or its least
    likely; the port's plain sampler (autoregressive) matches p too."""
    v, n = 12, 6000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0, 1.5, (1, 3, v)).astype(np.float32))
    kw = dict(temp=1.3, top_k=6)
    p = torch.softmax(tsampler._temperature_logits(logits[0, 0], **kw), -1).numpy()
    tol = 4.0 * np.sqrt(np.maximum(p * (1 - p), 1e-9) / n) + 1e-3
    verify = tsampler.make_spec_verifier("temperature", pad_id=0, **kw)
    assert verify.draws
    gens = [torch.Generator().manual_seed(i) for i in range(n)]
    ar = np.asarray([int(tsampler.temperature(logits[0, :1], g, **kw)[0]) for g in gens])
    assert np.all(np.abs(np.bincount(ar, minlength=v) / n - p) < tol)
    for d0 in (int(np.argmax(p)), int(np.argmin(p))):
        drafts = torch.tensor([[d0, 1]])
        gens = [torch.Generator().manual_seed(10_000 + i) for i in range(n)]
        firsts, emits = [], []
        for g in gens:
            out, n_emit = verify(logits, drafts, [g])
            firsts.append(int(out[0, 0]))
            emits.append(int(n_emit[0]))
        freq = np.bincount(firsts, minlength=v) / n
        assert np.all(np.abs(freq - p) < tol), (d0, freq, p)
        assert 1 <= min(emits) and max(emits) <= 3


def test_verifier_validation_matches_reference():
    for kind, kw in (("temperature", {"typo": 1}), ("greedy", {"top_k": 2}),
                     ("nope", {})):
        with pytest.raises(ValueError) as want:
            jsampler.make_spec_verifier(kind, **kw)
        with pytest.raises(ValueError) as got:
            tsampler.make_spec_verifier(kind, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jsampler.make_spec_verifier(lambda logits, key: logits)
    with pytest.raises(ValueError) as got:
        tsampler.make_spec_verifier(lambda logits, g: logits)
    assert str(got.value) == str(want.value)


def test_draft_model_and_sampler_errors_match_reference():
    """A recurrent draft model and a callable sampler fail as the
    reference's do (the port builds no SSM model, so a config stands in)."""
    ssm = types.SimpleNamespace(cfg=types.SimpleNamespace(family="ssm", rope_type="none"))
    with pytest.raises(ValueError) as want:
        jspec.DraftModelProposer(ssm, None, k=3)
    with pytest.raises(ValueError) as got:
        tspec.DraftModelProposer(ssm, None, k=3)
    assert str(got.value) == str(want.value)
    m, p = _model("olmo-1b", False, "int_pallas")
    eng = Engine(m, p, max_new=4, sampler=lambda logits, g: torch.argmax(logits, -1))
    with pytest.raises(ValueError, match="registry sampler"):
        eng.serve(_mixed(m.cfg.vocab)[:2], ServeOptions(slots=2, speculative=True))


# ------------------------------------------------------------- serving parity


def _mixed(vocab, seed=0, n=6):
    """tests/test_speculative.py's mixed trace."""
    rng = np.random.default_rng(seed)
    shapes = [(4, 6, 0.0), (8, 3, 0.0), (5, 8, 1.0), (4, 2, 3.0),
              (6, 5, 5.0), (8, 7, 6.0)][:n]
    return [Request(rid=i, prompt=rng.integers(0, vocab, (p,), dtype=np.int32),
                    max_new=mn, arrival=a, seed=100 + i)
            for i, (p, mn, a) in enumerate(shapes)]


def _repeating(vocab, seed=0):
    """Prompts that repeat a motif, so n-gram drafts are often accepted,
    one class-0 arrival that preempts a class-1 request, and a shared
    prefix."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, (8,), dtype=np.int32)
    out = []
    for i, (a, pr) in enumerate(((0.0, 1), (0.0, 1), (3.0, 0), (4.0, 1))):
        motif = rng.integers(0, vocab, (3,), dtype=np.int32)
        out.append(Request(rid=i, prompt=np.concatenate([pre, np.tile(motif, 3)]),
                           max_new=10, arrival=a, seed=300 + i, priority=pr))
    return out


PAGED = dict(slots=2, paged=True, block_size=4)
SERVE_CASES = {
    "contiguous": ("olmo-1b", False, "int_pallas", _mixed, dict(slots=2)),
    "paged": ("olmo-1b", False, "int_pallas", _mixed, PAGED),
    "prefix-share-pallas": ("olmo-1b", False, "int_pallas", _repeating,
                            dict(prefix_share=True, kernel="pallas", **PAGED)),
    "int8-pallas": ("olmo-1b", True, "int_pallas", _mixed, dict(kernel="pallas", **PAGED)),
    "chunked-preempting": ("olmo-1b", False, "int_pallas", _repeating,
                           dict(prefill_chunk=3, preemption=True, num_blocks=12,
                                prefix_share=True, **PAGED)),
    "mla-pallas-chunked-preempting": ("minicpm3-4b", False, "int_pallas", _repeating,
                                      dict(prefill_chunk=5, preemption=True, num_blocks=12,
                                           kernel="pallas", **PAGED)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_greedy_spec_serve_equals_plain_serve(case):
    """Greedy speculative serving emits the plain serve's tokens bitwise
    (whose own oracle is per-request eager), on every composed path; the
    draft accounting holds."""
    arch, quant, kind, trace, kw = SERVE_CASES[case]
    m, p = _model(arch, quant, kind)
    eng = Engine(m, p, max_new=10)
    reqs = trace(m.cfg.vocab)
    base = eng.serve(reqs, ServeOptions(**kw))
    spec = eng.serve(reqs, ServeOptions(speculative=True, draft_k=3, **kw))
    for a, b in zip(base.results, spec.results):
        assert np.array_equal(a.tokens, b.tokens) and a.done == b.done, a.rid
        assert 0 <= b.accepted <= b.drafted
    assert spec.speculative and spec.draft_k == 3 and spec.drafted_tokens > 0
    assert spec.drafted_tokens == sum(r.drafted for r in spec.results)
    assert spec.leaked_blocks == 0
    if kw.get("preemption"):
        assert spec.preemptions >= 1 and spec.resumes == spec.preemptions
    if trace is _repeating:
        assert spec.accepted_tokens > 0 and spec.steps < base.steps


def test_spec_serve_eos_parity():
    """EOS inside a verified block truncates where the plain loop stops
    (done flag, pad fill, early release)."""
    m, p = _model("olmo-1b", False, "int_pallas")
    probe_prompt = np.random.default_rng(0).integers(0, m.cfg.vocab, (1, 5)).astype(np.int32)
    eos = int(Engine(m, p, max_new=8).generate(probe_prompt).tokens[0, 5 + 2])
    eng = Engine(m, p, max_new=8, eos_id=eos)
    reqs = _mixed(m.cfg.vocab) + [Request(rid=6, prompt=probe_prompt[0], max_new=8,
                                          arrival=0.0, seed=200)]
    base = eng.serve(reqs, ServeOptions(slots=2))
    spec = eng.serve(reqs, ServeOptions(slots=2, speculative=True, draft_k=3))
    for a, b in zip(base.results, spec.results):
        assert np.array_equal(a.tokens, b.tokens) and a.done == b.done, a.rid
    assert spec.by_rid()[6].done


def test_self_draft_full_acceptance():
    """A draft model that IS the target accepts every draft, so rounds
    shrink while the tokens stay the plain serve's; the draft phase is
    metered and the phases partition the batch meter with the prefills.
    The second serve re-uses the proposer's kept state."""
    m, p = _model("olmo-1b", False, "int_pallas")
    eng = Engine(m, p, max_new=8)
    reqs = _mixed(m.cfg.vocab)
    base = eng.serve(reqs, ServeOptions(slots=2))
    opts = ServeOptions(slots=2, speculative=True, draft_k=3, draft="model", draft_model=m,
                        draft_params=p, report_cost=True)
    spec = eng.serve(reqs, opts)
    for a, b in zip(base.results, spec.results):
        assert np.array_equal(a.tokens, b.tokens), a.rid
    assert spec.acceptance_rate == 1.0 and spec.steps < base.steps
    assert spec.cost_draft.cycles > 0 and spec.cost_verify.cycles > 0
    assert spec.cost_draft.cycles + spec.cost_verify.cycles < spec.cost.cycles
    again = eng.serve(reqs, opts)
    assert len(eng._proposers) == 1
    assert all(np.array_equal(a.tokens, b.tokens) for a, b in zip(spec.results, again.results))


def test_stochastic_spec_serve_budgets():
    """A sampler that draws: budgets, prompt rows and report bookkeeping
    hold (bit parity is greedy's guarantee; the distribution oracle is the
    verifier test), and one seed replays the same tokens."""
    m, p = _model("olmo-1b", False, "int_pallas")
    eng = Engine(m, p, max_new=8, sampler="temperature", temp=1.3, top_k=8)
    reqs = _mixed(m.cfg.vocab, seed=3)
    opts = ServeOptions(speculative=True, draft_k=3, **PAGED)
    rep = eng.serve(reqs, opts)
    for r, q in zip(rep.results, reqs):
        assert r.tokens.shape == (q.prompt_len + q.max_new,)
        assert np.array_equal(r.tokens[:q.prompt_len], q.prompt)
    again = eng.serve(reqs, opts)
    assert all(np.array_equal(a.tokens, b.tokens) for a, b in zip(rep.results, again.results))


class _NoHostRead(TorchDispatchMode):
    """Fails on the op behind a host read of a tensor value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert "_local_scalar_dense" not in str(func), "host read in a captured step"
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_round_reads_nothing_back(kv_quant):
    """The greedy verify round (verify step, verifier, rollback) of the
    paged pallas path dispatches no host read, so a CUDA graph captures it
    whole; it re-uses its state (one per shape) across serves."""
    m, p = _model("olmo-1b", kv_quant, "int_pallas")
    eng = Engine(m, p, max_new=6)
    st = eng._spec_state("pallas", 2, 16, (4, 9), 3)
    st.buffers[0].copy_(torch.tensor([[1, 2, 3, 4, 5], [0, 0, 0, 0, 16]]))
    with _NoHostRead():
        packed, logits = st.run(False)
    assert packed.shape == (2, 5) and logits.shape == (2, 4, m.cfg.vocab)
    assert eng._spec_state("pallas", 2, 16, (4, 9), 3) is st


@pytest.mark.parametrize("arch,kernel,geom", [("olmo-1b", "jnp", None),
                                               ("olmo-1b", "pallas", (4, 13)),
                                               ("minicpm3-4b", "pallas", (4, 13)),
                                               ("mamba2-780m", "jnp", None),
                                               ("hymba-1.5b", "pallas", (4, 13))])
def test_verify_round_runs_on_meta(arch, kernel, geom):
    """The verify round (greedy: verify step, verifier and rollback; with a
    sampler that draws: the verify step, whose output is its logits beside
    its staged tree) on meta parameters, cache and inputs: a host read
    raises on a meta tensor, so it reads nothing back."""
    from repro_torch.serving.engine import _to_meta

    m, p = _model(arch, False, "int_pallas")
    meta = Model(m.cfg, dtype=torch.bfloat16, device="meta")
    for sampler, kw in (("greedy", {}), ("temperature", {"temp": 0.7})):
        eng = Engine(meta, _to_meta(p), sampler=sampler, **kw)
        st = eng._spec_state(kernel, 3, 16, geom, 2)
        out = st.body()
        if sampler == "greedy":
            packed, logits = out
            assert tuple(packed.shape) == (3, 4) and packed.device.type == "meta"
        else:
            logits, _ = out
        assert tuple(logits.shape) == (3, 3, m.cfg.vocab) and st.draws == (sampler != "greedy")


@pytest.mark.cuda
def test_spec_serve_graph_equals_op_by_op_on_card():
    """On the card the greedy verify round is one CUDA-graph replay, bitwise
    equal to the same round op by op."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the verify round's graph has no CPU mode")
    cfg = smoke_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    m = Model(cfg, device="cuda")
    p = m.init(torch.Generator("cuda").manual_seed(0))
    reqs = _mixed(cfg.vocab)
    opts = ServeOptions(speculative=True, draft_k=3, kernel="pallas", **PAGED)
    graphed = Engine(m, p, max_new=8).serve(reqs, opts)
    op = Engine(m, p, max_new=8)
    op._cuda_graphs = False
    ref = op.serve(reqs, opts)
    for a, b in zip(graphed.results, ref.results):
        assert np.array_equal(a.tokens, b.tokens), a.rid
