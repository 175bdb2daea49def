"""The recurrent families' caches in the port (``repro_torch.models.kv_cache``)
against the reference's (``repro.models.kv_cache``), bitwise.

* ``cache_zeros`` / ``paged_cache_zeros`` of the smoke mamba2-780m and
  hymba-1.5b (bf16, and hymba's int8 layout under ``kv_quant``): the same
  nested structure, shapes, dtypes and fills (zeros, ring positions -1,
  table sentinels).
* On random contents of the same numpy draw: ``paged_scatter`` (pools
  through the table, slot-resident stripes at batch axis 1),
  ``slot_scatter`` / ``slot_prefix_view``, ``swap_read`` and
  ``swap_write`` (blocks and stripes, into other block ids), and
  ``commit_staged`` (recurrent snapshots selected per row, positional
  tails cleared, contiguous and paged).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.models import kv_cache as jkv
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.models import kv_cache as tkv

torch.set_num_threads(2)

CASES = {"mamba2-780m": ("mamba2-780m", False), "hymba-1.5b": ("hymba-1.5b", False),
         "hymba-1.5b int8": ("hymba-1.5b", True)}
SLOTS, C, BS, NB = 3, 64, 16, 13
_J = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int8: jnp.int8,
      torch.int32: jnp.int32}


def _cfgs(case):
    arch, quant = CASES[case]
    return (dataclasses.replace(jsmoke(arch), kv_quant=quant),
            dataclasses.replace(tsmoke(arch), kv_quant=quant))


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_trees_equal(want, got, what=""):
    assert isinstance(got, dict) == isinstance(want, dict), what
    if isinstance(got, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in got:
            _assert_trees_equal(want[k], got[k], f"{what}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape, want.shape)
    assert _J[got.dtype] == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_zeros_match_reference(case):
    jcfg, tcfg = _cfgs(case)
    _assert_trees_equal(jkv.cache_zeros(jcfg, SLOTS, C), tkv.cache_zeros(tcfg, SLOTS, C),
                        "contiguous")
    _assert_trees_equal(jkv.paged_cache_zeros(jcfg, SLOTS, C, BS, NB),
                        tkv.paged_cache_zeros(tcfg, SLOTS, C, BS, NB), "paged")


def _random(tree, rng, table_fill=None):
    """A numpy tree of random contents shaped as ``tree`` (torch): floats
    normal, int8 codes, ring positions in [-1, 100), block tables of valid
    ids and sentinels."""
    def leaf(k, v):
        shape = tuple(v.shape)
        if k == "table":
            return rng.integers(0, NB + 1, size=shape).astype(np.int32)
        if v.dtype == torch.int32:
            return rng.integers(-1, 100, size=shape).astype(np.int32)
        if v.dtype == torch.int8:
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        return rng.normal(0, 1, size=shape).astype(np.float32)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in t.items()}
    return walk(tree)


def _both(tree_np, like):
    """(jax tree, torch tree) of the numpy ``tree_np`` in ``like``'s dtypes."""
    j = jax.tree.map(lambda a, t: jnp.asarray(a, _J[t.dtype]), tree_np, like)
    t = tkv.tree_map(lambda a, t: torch.from_numpy(np.array(a)).to(t.dtype), tree_np, like)
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_paged_scatter_matches_reference(case):
    jcfg, tcfg = _cfgs(case)
    rng = np.random.default_rng(0)
    like = tkv.paged_cache_zeros(tcfg, SLOTS, C, BS, NB)
    jc, tc = _both(_random(like, rng), like)
    # a batch-1 prefill cache of 40 positions (rings of the window, SSM state)
    pre = tkv.cache_zeros(tcfg, 1, 40)
    if tcfg.family == "hybrid":
        pre["full"]["attn"] = {k: v[:, :, :40] for k, v in pre["full"]["attn"].items()}
    jv, tv = _both(_random(pre, rng), pre)
    slot, t0, t1 = 1, 8, 40
    ids = np.asarray([4, 9, 2], np.int64)
    row = np.full((C // BS,), NB, np.int32)
    row[:3] = ids
    wpos = np.arange(t0, t1)
    pb, offs = ids[wpos // BS].astype(np.int32), (wpos % BS).astype(np.int32)
    pb[3] = NB                                   # a dropped coordinate
    want = jkv.paged_scatter(jc, jv, jnp.int32(slot), jnp.asarray(row), jnp.asarray(pb),
                             jnp.asarray(offs), t0, t1)
    got = tkv.paged_scatter(tc, tv, slot, row, pb, offs, t0, t1)
    assert got is tc
    _assert_trees_equal(want, got)


@pytest.mark.parametrize("case", list(CASES))
def test_slot_scatter_and_prefix_view_match_reference(case):
    jcfg, tcfg = _cfgs(case)
    rng = np.random.default_rng(1)
    like = tkv.cache_zeros(tcfg, SLOTS, C)
    jc, tc = _both(_random(like, rng), like)
    vals = tkv.tree_map(lambda v: v[:, :1], like)
    jv, tv = _both(_random(vals, rng), vals)
    want = jkv.slot_scatter(jc, jv, jnp.int32(2), jnp.int32(1), 0, 2)
    got = tkv.slot_scatter(tc, tv, 2, 1, 0, 2)
    _assert_trees_equal(want, got)
    _assert_trees_equal(jkv.slot_prefix_view(want, jnp.int32(2), 3),
                        tkv.slot_prefix_view(got, 2, 3))


@pytest.mark.parametrize("case", list(CASES))
def test_swap_round_trip_matches_reference(case):
    jcfg, tcfg = _cfgs(case)
    rng = np.random.default_rng(2)
    like = tkv.paged_cache_zeros(tcfg, SLOTS, C, BS, NB)
    jc, tc = _both(_random(like, rng), like)
    ids, new_ids = [3, 7], [11, 0]
    want_pay = jkv.swap_read(jc, jnp.int32(1), jnp.asarray(ids, jnp.int32))
    got_pay = tkv.swap_read(tc, 1, ids)
    assert all(v.device.type == "cpu" for v in tkv.tree_leaves(got_pay))
    _assert_trees_equal(want_pay, got_pay, "payload")
    # the stripes were copied: a write to the slot leaves the payload alone
    for v in tkv.tree_leaves(tc):
        if v.dtype != torch.int32:
            v[:, 1] = 0
    row = np.full((C // BS,), NB, np.int32)
    row[:2] = new_ids
    jc = jax.tree.map(jnp.asarray, tkv.tree_map(lambda v: _np(v).astype(
        np.asarray(jnp.zeros((), _J[v.dtype])).dtype), tc))
    want = jkv.swap_write(jc, want_pay, jnp.int32(0), jnp.asarray(new_ids, jnp.int32),
                          jnp.asarray(row))
    got = tkv.swap_write(tc, got_pay, 0, new_ids, row)
    _assert_trees_equal(want, got, "restored")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("case", ["mamba2-780m", "hymba-1.5b"])
def test_commit_staged_selects_snapshots_as_reference(case, paged):
    """A staged verify tree: recurrent nodes as snapshots [L, T, B, ...],
    positional nodes (hymba's global layers, contiguous or paged) with all
    T entries; per-row accepted depths with parked and over-draft rows."""
    jcfg, tcfg = _cfgs(case)
    rng = np.random.default_rng(3)
    t = 3
    base = (tkv.paged_cache_zeros(tcfg, SLOTS, C, BS, NB) if paged
            else tkv.cache_zeros(tcfg, SLOTS, C))

    def staged(node):
        if "state" in node or "pos" in node:
            return {k: v[:, None].expand((v.shape[0], t) + tuple(v.shape[1:])).contiguous()
                    for k, v in node.items()}
        if all(not isinstance(v, dict) for v in node.values()):
            return node
        return {k: staged(v) for k, v in node.items()}

    like = staged(base)
    jst, tst = _both(_random(like, rng), like)
    pos = np.asarray([5, C, C - 2], np.int32)
    for n_acc in ([0, 1, 2], [2, 0, 1]):
        n = np.asarray(n_acc, np.int32)
        want = jkv.commit_staged(jst, jnp.asarray(n), jnp.asarray(pos), t)
        got = tkv.commit_staged(tkv.tree_map(lambda v: v.clone(), tst), torch.from_numpy(n),
                                torch.from_numpy(pos), t)
        _assert_trees_equal(want, got, str(n_acc))
