"""K3's tiled passes, checked on the CPU through its plain tiled version.

The CUDA kernel (``csrc/int_attention.cu``) runs one CTA per (head, query
tile) over the key tiles of ``ref.k3_plan`` in three exact Alg.-1 passes:
tile maxima into the row max, int64 tile sums into the row sum, then each
tile's probabilities and its P V in key order, recomputing QK^T in each
pass. ``int_attention_tiled(..., q_tile, k_tile)`` mirrors those passes;
these tests hold it:

* its scores and probabilities bitwise equal to ``int_attention_ref(...,
  return_rows=True)`` (the whole-row plain version the wrapper runs on the
  CPU), and its outputs within the f32 summation bound of the exact sum
  over those probabilities and of the whole-row version's, over tiles of
  64, 7 and 1 and the kernel's own (bf16: 128 query rows x 64 keys; f32: 64
  x 16), at ``BEST``, M=4 and a config whose sum saturates, on right-aligned
  tails, rows that see no key, ragged query tiles, windows, GQA, d 8 and 24
  (padding) and bf16 inputs;
* the JAX ``int_attention_pallas`` in interpret mode (as
  ``tests/test_torch_int_attention.py`` runs it), within that file's
  tolerances;
* the plan: every valid (query, key) pair inside a visited key tile of its
  query tile, no visited tile wholly masked for its query tile, the
  kernel's shared memory independent of the number of keys and within the
  227 KB a CTA may take up to d 256;
* the two faults ``chip_smoke.py --fault-control`` patches in are caught.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.precision import BEST as JBEST
from repro.kernels.int_attention.ops import int_attention_pallas
from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.kernels.int_attention import ref
from repro_torch.kernels.int_attention.ref import (
    K3_MAX_D, attention_mask, int_attention_ref, int_attention_tiled, k3_plan, k3_smem_bytes,
    k3_tiles,
)
from repro_torch.kernels.int_softmax import ref as k1_ref

torch.set_num_threads(2)

U = 2.0 ** -24 * (1 + 2.0 ** -8)          # f32 unit roundoff, with room for its own rounding
SMEM_OPTIN = 232448                        # the 227 KB a CTA may take on the H100

# scenario -> (B, H, KV, Sq, Skv, D, causal, window, dtype)
SCENARIOS = {
    "causal": (1, 2, 2, 40, 40, 16, True, 0, torch.float32),
    "not causal": (1, 2, 1, 24, 40, 16, False, 0, torch.float32),
    "tail 128 on 512": (1, 1, 1, 128, 512, 16, True, 0, torch.float32),
    "Sq > Skv": (1, 2, 2, 40, 32, 16, True, 0, torch.float32),
    "ragged Sq 33": (1, 2, 2, 33, 33, 16, True, 0, torch.float32),
    "ragged Sq 100": (1, 1, 1, 100, 100, 16, True, 0, torch.float32),
    "window 5": (1, 2, 1, 48, 48, 16, True, 5, torch.float32),
    "window 16": (1, 2, 2, 64, 80, 16, True, 16, torch.float32),
    "GQA 4": (1, 8, 2, 32, 32, 16, True, 0, torch.float32),
    "d 8": (1, 2, 2, 24, 24, 8, True, 0, torch.float32),
    "d 24": (1, 2, 2, 24, 24, 24, True, 0, torch.float32),
    "bf16": (1, 2, 2, 40, 40, 32, True, 0, torch.bfloat16),
}
# (query rows, keys) a tile; "kernel" is k3_tiles for the scenario's dtype
TILES = {"kernel": None, "64": (64, 64), "7": (7, 7), "1": (1, 1)}
CFGS = {"best": BEST, "m4": PrecisionConfig(M=4, T_C=-4.0),
        "saturating": PrecisionConfig(M=6, N=0, T_C=-7.0)}
SLOW_WITH_TILES_OF_1 = {"tail 128 on 512"}       # ~57k key tiles of one key


def _cases():
    for name in SCENARIOS:
        for tiles in TILES:
            if tiles == "1" and name in SLOW_WITH_TILES_OF_1:
                continue
            for cfg in CFGS if tiles in ("kernel", "7") else ("best",):
                yield name, tiles, cfg


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """q [B, H, Sq, D], k, v [B, KV, Skv, D] from a seeded numpy generator,
    in the scenario's dtype."""
    b, h, kv, sq, skv, d, _, _, dtype = SCENARIOS[name]
    rng = np.random.default_rng(sorted(SCENARIOS).index(name))
    return tuple(torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
                 for shape in ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))


def _kernel_tiles(name):
    """The kernel's tiles for the scenario on a card of 132 SMs."""
    b, h, _, sq, _, d, _, _, dtype = SCENARIOS[name]
    return k3_tiles(dtype, d, b * h, sq, 132)


def _tiles(name, tiles):
    return _kernel_tiles(name) if TILES[tiles] is None else TILES[tiles]


def _kw(name):
    causal, window = SCENARIOS[name][6:8]
    return dict(causal=causal, window=window)


def _pv_bound(probs, v, h, dtype, valid):
    """The exact f64 sum over ``probs`` (rounded to ``dtype``) and the f32
    bound of any summation order over each row's n valid keys, n 2^-24 sum
    |p| |v|, both [B * H, Sq, D]."""
    b, kv, skv, d = v.shape
    vg = v.double()[:, :, None].expand(b, kv, h // kv, skv, d).reshape(b * h, skv, d)
    p = probs.to(dtype).double()
    n = valid.sum(-1, keepdim=True).double()
    return p @ vg, n * U * (p.abs() @ vg.abs())


@pytest.mark.parametrize("name,tiles,cfg", list(_cases()))
def test_tiled_equals_whole_rows(name, tiles, cfg):
    q, k, v = _inputs(name)
    kw = _kw(name)
    c = CFGS[cfg]
    want, want_sc, want_pr = int_attention_ref(q, k, v, c, return_rows=True, **kw)
    q_tile, k_tile = _tiles(name, tiles)
    out, sc, pr = int_attention_tiled(q, k, v, c, q_tile=q_tile, k_tile=k_tile, return_rows=True,
                                      **kw)
    assert torch.equal(sc, want_sc)
    assert torch.equal(pr, want_pr)
    b, h, sq, d = q.shape
    mask = attention_mask(sq, k.shape[2], kw["causal"], kw["window"])
    valid = torch.ones((sq, k.shape[2]), dtype=torch.bool) if mask is None else mask
    exact, bound = _pv_bound(pr, v, h, v.dtype, valid)
    got, whole = out.reshape(b * h, sq, d).double(), want.reshape(b * h, sq, d).double()
    assert bool(((got - exact).abs() <= bound).all())
    assert bool(((got - whole).abs() <= 2 * bound).all())
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tiled_matches_jax_kernel(name):
    """Against the reference's Pallas kernel in interpret mode: 5e-3 in f32,
    2e-2 for bf16 inputs (tests/test_torch_int_attention.py)."""
    q, k, v = _inputs(name)
    kw = _kw(name)
    q_tile, k_tile = _kernel_tiles(name)
    got = int_attention_tiled(q, k, v, BEST, q_tile=q_tile, k_tile=k_tile, **kw).numpy()
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jdt) for x in (q, k, v))
    kern = np.asarray(int_attention_pallas(jq, jk, jv, JBEST, blk_q=16, **kw))
    assert float(np.abs(got - kern).max()) < (2e-2 if q.dtype == torch.bfloat16 else 5e-3)


def test_saturating_config_saturates():
    """The saturating config really clips a row sum (so the tests above
    exercise the clip)."""
    q, k, _ = _inputs("causal")
    c = CFGS["saturating"]
    from repro_torch.core.alg1 import int_exp_codes
    from repro_torch.core.quantization import quantize_stable_scores

    _, sc, _ = int_attention_ref(q, k, k, c, return_rows=True)
    mask = attention_mask(40, 40, True, 0)
    codes = int_exp_codes(quantize_stable_scores(sc, c, mask=mask), c)
    sums = torch.where(mask, codes, 0).sum(-1, dtype=torch.int64)
    assert int(sums.max()) > c.sum_saturation


PLAN_SHAPES = [(40, 40, True, 0), (24, 40, False, 0), (128, 512, True, 0), (40, 32, True, 0),
               (100, 100, True, 0), (48, 48, True, 5), (64, 80, True, 16),
               (1000, 1000, True, 0), (4096, 4096, True, 1024), (64, 65536, True, 0)]


@pytest.mark.parametrize("sq,skv,causal,window", PLAN_SHAPES)
@pytest.mark.parametrize("q_tile,k_tile", [(128, 64), (64, 64), (64, 16), (7, 7)])
def test_plan_visits_every_valid_pair_and_no_empty_tile(sq, skv, causal, window, q_tile,
                                                        k_tile):
    """Every valid (query, key) pair lies in a visited key tile of its query
    tile (tiles are disjoint, so in exactly one); no visited key tile is
    wholly masked for every row of its query tile."""
    plan = k3_plan(sq, skv, causal, window, q_tile, k_tile)
    assert plan.q_tile == q_tile and plan.k_tile == k_tile
    assert len(plan.key_tiles) == -(-sq // q_tile)
    mask = attention_mask(sq, skv, causal, window)
    valid = torch.ones((sq, skv), dtype=torch.bool) if mask is None else mask
    assert not bool((valid & ~plan.visited(sq, skv)).any())
    per_tile = torch.nn.functional.pad(valid, (0, (-skv) % k_tile, 0, (-sq) % q_tile))
    per_tile = per_tile.unflatten(0, (-1, q_tile)).unflatten(2, (-1, k_tile)).any(3).any(1)
    for i, (a, b) in enumerate(plan.key_tiles):
        assert 0 <= a <= b <= -(-skv // k_tile)
        assert bool(per_tile[i, a:b].all())
        assert not bool(per_tile[i, :a].any() or per_tile[i, b:].any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 24, 64, 128, 136, 256])
@pytest.mark.parametrize("m", [6, 14, 15])
def test_shared_memory_depends_on_d_alone_and_fits(dtype, d, m):
    """A CTA's shared memory is a function of d, the dtype and M (the plan
    takes any number of keys) and stays within the card's 227 KB up to d
    256, the exp table of M=14 included."""
    need = k3_smem_bytes(d, dtype, m)
    assert 0 < need <= SMEM_OPTIN
    assert d <= K3_MAX_D
    # the plan of a 65536-key row is 64 queries' one tile: no cap on context
    q_tile, k_tile = k3_tiles(dtype, d, 4, 64, 132)
    assert k3_plan(64, 65536, True, 0, q_tile, k_tile).key_tiles == ((0, 65536 // k_tile),)


@pytest.mark.parametrize("dtype,d,bh,sq,want", [
    (torch.bfloat16, 128, 16, 4096, (128, 64)),     # 512 wide CTAs: 3.9 a SM
    (torch.bfloat16, 128, 32, 2048, (128, 64)),     # GQA 32/8
    (torch.bfloat16, 128, 64, 512, (64, 64)),       # olmo-1b prefill: 256 wide CTAs
    (torch.bfloat16, 24, 4, 70, (64, 64)),
    (torch.bfloat16, 256, 16, 4096, (64, 64)),      # past d 128: the cp.async path
    (torch.float32, 64, 16, 4096, (64, 16)),
])
def test_kernel_tiles(dtype, d, bh, sq, want):
    """128 query rows a tile (two warpgroups) where the grid keeps two CTAs
    on each of 132 SMs, else 64; 16 keys a tile for f32."""
    assert k3_tiles(dtype, d, bh, sq, 132) == want


def _own_tile_max(chunk_max):
    return chunk_max


def _last_tile_dropped(partials):
    acc = torch.zeros_like(partials[0])
    for part in partials[:-1]:
        acc = acc + part
    return acc


@pytest.mark.parametrize("fault", ["own tile max", "last tile's PV dropped"])
def test_faults_are_caught(fault, monkeypatch):
    """The faults chip_smoke.py --fault-control patches into the tiled
    version: each key tile quantizing against its own max breaks the
    bitwise probabilities; one key tile's PV dropped breaks the PV bound."""
    q, k, v = _inputs("tail 128 on 512")
    kw = _kw("tail 128 on 512")
    if fault == "own tile max":
        monkeypatch.setattr(k1_ref, "split_row_max", _own_tile_max)
    else:
        monkeypatch.setattr(ref, "combine_partials", _last_tile_dropped)
    want = int_attention_ref(q, k, v, BEST, return_rows=True, **kw)
    out, _, pr = int_attention_tiled(q, k, v, BEST, q_tile=64, k_tile=64, return_rows=True,
                                     **kw)
    if fault == "own tile max":
        assert not torch.equal(pr, want[2])
    else:
        assert torch.equal(pr, want[2])
        mask = attention_mask(128, 512, True, 0)
        exact, bound = _pv_bound(pr, v, 1, v.dtype, mask)
        err = (out.reshape(1, 128, 16).double() - exact).abs() / (bound + 1e-300)
        assert float(err.max()) > 100
