"""The hybrid (hymba-1.5b) and SSM (mamba2-780m) models of the port
against the reference, and their verify step inside the port.

* Ring attention (``attn_decode_ring`` / ``attn_verify_ring``) against the
  reference's on the same numpy inputs (f32 compute, the reference's
  parameters of a window layer): per-row positions that wrap the ring and
  rows still filling it; outputs within 1e-5 relative to their scale, the
  ring's K/V within 1e-6 and its positions exactly, every verify
  snapshot too.
* The reference's wraparound oracle (window 8, 40 tokens: the ring wraps
  4 times): the port's decode against its own ``train_logits`` within the
  reference's 0.35 (bf16), and against the reference's decode.
* ``Model.prefill`` / ``decode_step`` / ``verify_step`` of both smoke
  models against the reference (f32 compute, the reference's parameters):
  logits within 1e-4, the SSM state within 1e-4 relative, the positional
  and ring caches within 1e-5 relative, ring positions exactly.
* Inside the port, bitwise (bf16 compute): a T-token ``verify_step``
  equals T ``decode_step`` calls (logits; the cache committed at full
  acceptance, and at full rejection the cache of one decode step),
  contiguous and paged (K2's plain version for hymba's global layers),
  as ``tests/test_speculative.py`` holds the reference.
* The full-width parameter counts on the ``meta`` device: 0.83e9 and 1.5e9
  within the reference's 12 %.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.core.softmax_variants import SoftmaxSpec as JSpec
from repro.models import attention as jatt
from repro.models.layers import Ctx as JCtx
from repro.models.model import Model as JModel
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.models import attention as tatt
from repro_torch.models import kv_cache as tkv
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_params

torch.set_num_threads(2)

ARCHS = ["mamba2-780m", "hymba-1.5b"]
_PAIRS = {}


def _pair(arch, kind="int_pallas", **over):
    """(reference model, its params, port model, the same params), f32."""
    key = (arch, kind, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jcfg = dataclasses.replace(jsmoke(arch, softmax=JSpec(kind)), **over)
        tcfg = dataclasses.replace(tsmoke(arch, softmax=SoftmaxSpec(kind)), **over)
        jm = JModel(jcfg, dtype=jnp.float32)
        jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.float32)
        _PAIRS[key] = (jm, jp, Model(tcfg, dtype=torch.float32, device="cpu"), tp)
    return _PAIRS[key]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(want, got, rel, what):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(want - got).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} x {scale}"


def _tree_close(want, got, rel, what):
    if isinstance(got, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in got:
            _tree_close(want[k], got[k], rel, f"{what}/{k}")
    elif got.dtype in (torch.int32, torch.int64):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
    else:
        _close(want, got, rel, what)


# ------------------------------------------------------------- ring attention


def _ring_inputs(cfg, w, positions, seed=0):
    """A ring of W slots per row holding, for each row at ``positions[b]``,
    the positions a decode up to there leaves (-1 where empty), with random
    K/V; and x [B, 1, d]."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    kv = rng.normal(0, 1, (2, b, w, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    last = np.asarray(positions)[:, None] - 1
    stored = last - np.mod(last - np.arange(w)[None, :], w)
    stored = np.where(stored >= 0, stored, -1).astype(np.int32)
    x = rng.normal(0, 1, (b, 1, cfg.d_model)).astype(np.float32)
    return {"k": kv[0], "v": kv[1], "pos": stored}, x


def _ring_layer(arch="hymba-1.5b"):
    jm, jp, tm, tp = _pair(arch)
    return (jm.cfg, tm.cfg, jax.tree.map(lambda a: a[0], jp["stack"]["win_a"]["attn"]),
            layer_params(tp["stack"]["win_a"]["attn"], 0))


@pytest.mark.parametrize("pos_kind", ["per-row", "scalar"])
def test_ring_decode_matches_reference(pos_kind):
    cfg, tcfg, jp, tp = _ring_layer()
    w = cfg.window
    positions = [5, 40, 77] if pos_kind == "per-row" else [40, 40, 40]
    ring, x = _ring_inputs(cfg, w, positions)
    cp_j = jnp.asarray(positions, jnp.int32) if pos_kind == "per-row" else jnp.int32(40)
    cp_t = torch.as_tensor(positions, dtype=torch.int32) if pos_kind == "per-row" else 40
    pj = jnp.asarray(positions, jnp.int32)[:, None]
    jy, jc = jatt.attn_decode_ring(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, ring), cp_j,
                                   cfg, JCtx(dtype=jnp.float32), pj, w)
    tc = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    ty, tc2 = tatt.attn_decode_ring(tp, torch.from_numpy(x), tc, cp_t, tcfg,
                                    TCtx(dtype=torch.float32),
                                    torch.as_tensor(positions, dtype=torch.int32)[:, None], w)
    assert tc2 is tc          # written in place
    _close(jy, ty, 1e-5, "y")
    _tree_close(jc, tc, 1e-6, "ring")


def test_ring_verify_snapshots_match_reference():
    """T = 4 tokens per row through the snapshotting ring scan: outputs and
    every snapshot [T, B, W, ...]; the ring ends at the last token."""
    cfg, tcfg, jp, tp = _ring_layer()
    w, t = cfg.window, 4
    positions = [3, 30, 61]                  # rows filling, at and past the wrap
    ring, _ = _ring_inputs(cfg, w, positions)
    x = np.random.default_rng(9).normal(0, 1, (3, t, cfg.d_model)).astype(np.float32)
    qpos = np.asarray(positions, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]
    jy, jsnap = jatt.attn_verify_ring(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, ring),
                                      jnp.asarray(positions, jnp.int32), cfg,
                                      JCtx(dtype=jnp.float32), jnp.asarray(qpos), w)
    tc = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    ty, tsnap = tatt.attn_verify_ring(tp, torch.from_numpy(x), tc,
                                      torch.as_tensor(positions, dtype=torch.int32), tcfg,
                                      TCtx(dtype=torch.float32), torch.from_numpy(qpos), w)
    _close(jy, ty, 1e-5, "y")
    _tree_close(jsnap, tsnap, 1e-6, "snapshots")
    for k in tc:
        assert torch.equal(tc[k], tsnap[k][-1]), k


def test_ring_wraparound_oracle():
    """The reference's oracle (tests/test_models_smoke.py): window 8, 40
    tokens, decode from position 4 wraps the 8-slot ring 4 times; the
    decoded logits stay within 0.35 of the whole-sequence forward (bf16),
    and within the same 0.35 of the reference's decode on the same
    parameters (bf16 roundings of two implementations over 6 layers)."""
    over = dict(window=8, max_seq=64, ssm_chunk=8)
    jcfg = dataclasses.replace(jsmoke("hymba-1.5b"), **over)
    tcfg = dataclasses.replace(tsmoke("hymba-1.5b"), **over)
    jm = JModel(jcfg)
    jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 40)).astype(np.int32)
    full, _ = tm.train_logits(tp, {"tokens": torch.as_tensor(toks, dtype=torch.long)})
    _, cache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :4], dtype=torch.long)},
                          cache_len=40)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :4])}, cache_len=40)
    dec = jax.jit(jm.decode_step)
    errs, ref_errs = [], []
    for t in range(4, 40):
        lg, cache = tm.decode_step(tp, cache, {"token": torch.as_tensor(
            toks[:, t:t + 1], dtype=torch.long)}, t)
        jl, jc = dec(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        errs.append(float((lg[:, 0].float() - full[:, t].float()).abs().max()))
        ref_errs.append(float(np.abs(np.asarray(jl[:, 0], np.float32) - _np(lg[:, 0])).max()))
    assert max(errs) < 0.35, max(errs)
    assert max(ref_errs) < 0.35, max(ref_errs)


# ---------------------------------------------------------------- the models


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_verify_match_reference(arch):
    """f32 compute: a 32-token prefill (one SSD chunk), 3 decode steps, a
    4-token verify block and its commit at a per-row accepted depth."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(4)
    b, p, c = 2, 32, 48
    toks = rng.integers(0, jm.cfg.vocab, (b, p + 8)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(
        jp, {"tokens": jnp.asarray(toks[:, :p])}, cache_len=c)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :p], dtype=torch.long)}, c)
    _close(jl, tl, 1e-4 / 4, "prefill logits")
    _tree_close(jc, tc, 1e-4, "prefill cache")
    dec = jax.jit(jm.decode_step)
    for t in range(p, p + 3):
        jl, jc = dec(jp, jc, {"token": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, {"token": torch.as_tensor(toks[:, t:t + 1],
                                                                  dtype=torch.long)}, t)
        _close(jl, tl, 1e-4 / 4, f"decode logits {t}")
    _tree_close(jc, tc, 1e-4, "decode cache")
    pos = p + 3
    block = toks[:, pos:pos + 4]
    jv, jst = jax.jit(jm.verify_step)(jp, jc, {"token": jnp.asarray(block)}, jnp.int32(pos))
    tv, tst = tm.verify_step(tp, tc, {"token": torch.as_tensor(block, dtype=torch.long)}, pos)
    _close(jv, tv, 1e-4 / 4, "verify logits")
    _tree_close(jst, tst, 1e-4, "staged")
    n = np.asarray([2, 0], np.int32)
    jcm = jm.verify_commit(jst, jnp.asarray(n), jnp.int32(pos), 4)
    tcm = tm.verify_commit(tst, torch.from_numpy(n), pos, 4, tc)
    assert tcm is tc
    _tree_close(jcm, tcm, 1e-4, "committed")


def test_prefill_tail_raises_for_recurrent_families():
    for arch in ARCHS:
        tm = Model(tsmoke(arch), device="cpu")
        with pytest.raises(NotImplementedError, match="prefills in full"):
            tm.prefill_tail({}, {"tokens": torch.zeros((1, 2), dtype=torch.long)}, {}, 4)


# ------------------------------------------- verify == decode steps (the port)

_MODELS = {}


def _model(arch, kind):
    if (arch, kind) not in _MODELS:
        m = Model(tsmoke(arch, softmax=SoftmaxSpec(kind)), device="cpu")
        _MODELS[arch, kind] = (m, m.init(torch.Generator().manual_seed(0)))
    return _MODELS[arch, kind]


def _clone(tree):
    return tkv.tree_map(lambda v: v.clone(), tree)


def _paged(cfg, cache, b, c, bs):
    """The contiguous prefill cache with hymba's global layers moved into
    private blocks of a fresh pool (the rings and SSM state stay
    slot-resident, as the serve's paged cache holds them)."""
    pool = tkv.paged_cache_zeros(cfg, b, c, bs, b * (c // bs) + 1)
    n_log = c // bs
    tkv.tree_map(lambda dst, src: dst.copy_(src), pool["win_a"], cache["win_a"])
    tkv.tree_map(lambda dst, src: dst.copy_(src), pool["win_b"], cache["win_b"])
    tkv.tree_map(lambda dst, src: dst.copy_(src), pool["full"]["ssm"], cache["full"]["ssm"])
    node = pool["full"]["attn"]
    for row in range(b):
        ids = torch.arange(row * n_log + 1, (row + 1) * n_log + 1)
        node["table"][:, row] = ids.to(torch.int32)
        for k in ("k", "v"):
            v = cache["full"]["attn"][k][:, row]
            node[k][:, ids] = v.reshape((v.shape[0], n_log, bs) + tuple(v.shape[2:]))
    return pool


VERIFY_CASES = {"mamba2-780m": ("mamba2-780m", False, "int_pallas"),
                "hymba-1.5b contiguous": ("hymba-1.5b", False, "int_pallas"),
                "hymba-1.5b paged pallas": ("hymba-1.5b", True, "int_pallas_paged")}


@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_verify_step_matches_sequential_decode(case):
    arch, paged, kind = VERIFY_CASES[case]
    m, p = _model(arch, kind)
    b, plen, t, bs = 2, 5, 4, 4
    c = max(16, m.cfg.window) if m.cfg.family == "hybrid" else 16
    rng = np.random.default_rng(1)
    logits, cache = m.prefill(p, {"tokens": torch.as_tensor(
        rng.integers(0, m.cfg.vocab, (b, plen)))}, cache_len=c)
    if paged:
        cache = _paged(m.cfg, cache, b, c, bs)
    pos = torch.full((b,), plen, dtype=torch.int32)
    toks = [torch.argmax(logits[:, -1], -1)[:, None]]
    seq_cache, seq_logits = _clone(cache), []
    for i in range(t):
        lg, seq_cache = m.decode_step(p, seq_cache, {"token": toks[-1]}, pos + i)
        seq_logits.append(lg[:, 0])
        toks.append(torch.argmax(lg[:, -1], -1)[:, None])
    block = torch.cat(toks[:t], dim=1)
    staged_cache = _clone(cache)
    v_logits, staged = m.verify_step(p, staged_cache, {"token": block}, pos)
    assert torch.equal(v_logits, torch.stack(seq_logits, 1))
    full = m.verify_commit(staged, torch.full((b,), t - 1, dtype=torch.int32), pos, t,
                           staged_cache)
    for a, w in zip(tkv.tree_leaves(full), tkv.tree_leaves(seq_cache)):
        assert torch.equal(a, w), a.shape
    # full rejection: the cache of the first token's decode step alone
    one = _clone(cache)
    _, one = m.decode_step(p, one, {"token": toks[0]}, pos)
    staged_cache = _clone(cache)
    _, staged = m.verify_step(p, staged_cache, {"token": block}, pos)
    none = m.verify_commit(staged, torch.zeros((b,), dtype=torch.int32), pos, t, staged_cache)
    for a, w in zip(tkv.tree_leaves(none), tkv.tree_leaves(one)):
        assert torch.equal(a, w), a.shape


@pytest.mark.parametrize("arch,want", [("mamba2-780m", 0.83e9), ("hymba-1.5b", 1.5e9)])
def test_full_width_param_count_on_meta(arch, want):
    """The port's full-width parameters (built on the meta device: shapes
    only) count the published size within the reference's 12 %, and the
    config's own count to the parameter."""
    cfg = get_config(arch)
    params = Model(cfg, device="meta").init()
    got = sum(v.numel() for v in tkv.tree_leaves(params))
    assert abs(got - want) / want < 0.12, (arch, got, want)
    assert got == cfg.param_count() or abs(got - cfg.param_count()) / got < 0.01, \
        (got, cfg.param_count())
