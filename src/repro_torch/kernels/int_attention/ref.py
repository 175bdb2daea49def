"""Plain PyTorch versions of K3, the fused prefill attention.

Port of ``src/repro/kernels/int_attention/ref.py:int_attention_ref`` with
the scores the kernel computes: the reference's oracle rounds the QK^T
einsum to the input dtype, while its Pallas kernel (and the CUDA kernel)
keep the f32-accumulated dot unrounded. So the products run in f32 on
upcast operands (exact for bf16 inputs), are scaled by d^-1/2 in f32,
masked right-aligned causal (query i at position i + Skv - Sq) with the
optional window, and go through the plain Alg. 1 (``int_softmax_block``,
the body K1-K4 reproduce); PV multiplies the probabilities rounded to v's
dtype and sums in f32, giving f32 out. GQA: head h reads kv head
h // (H / KV). The wrapper (``ops.py``) runs ``int_attention_ref`` for CPU
tensors; ``chip_smoke.py`` holds the kernel against it on the card.

The CUDA kernel (``csrc/int_attention.cu``) runs one CTA per (head, tile of
query rows) over the key tiles of ``k3_plan`` (tiles of ``k3_tiles``) in three exact
Alg.-1 passes: tile maxima into the row max, int64 tile sums into the row
sum, then each tile's probabilities and its PV, accumulated in key order.
``int_attention_tiled`` mirrors those passes over the same plan.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import PrecisionConfig
from repro_torch.kernels.int_softmax.ref import int_softmax_split_ref, k1_chunks
from repro_torch.kernels.paged_attention.ref import combine_partials

# The kernel's tiles (k3_tiles). bf16 up to d 128: Q in registers, the
# scores on wgmma, the tiles by TMA, 64 keys a tile and CTAs of two
# warpgroups (128 query rows) where that grid still gives every SM
# K3_WIDE_MIN_CTAS_PER_SM CTAs, else of one (64 rows, two CTAs an SM): the
# wider tile halves the K and V loads a query row, which set the pace at
# long rows; the narrower balances a short causal grid better (PERF.md
# §6). Otherwise (f32, bf16 past d 128) CTAs of 4 warps: 64 query rows, 64
# keys a tile for bf16 and 16 for f32 (its rows are twice as wide and Q
# stays in shared memory).
K3_MAX_D = 256
K3_TMA_MAX_D = 128
K3_MAX_TABLE_M = 14          # largest M with an exp table in shared memory
K3_WIDE_MIN_CTAS_PER_SM = 2


def k3_tiles(dtype, d: int, bh: int, sq: int, sms: int):
    """(query rows, keys) of the kernel's tiles for ``bh`` heads of ``sq``
    queries of ``dtype`` at head dim ``d`` on a card of ``sms`` SMs."""
    if dtype == torch.bfloat16 and d <= K3_TMA_MAX_D:
        wide = bh * -(-sq // 128) >= K3_WIDE_MIN_CTAS_PER_SM * sms
        return (128 if wide else 64), 64
    return 64, (64 if dtype == torch.bfloat16 else 16)


def attention_mask(sq: int, skv: int, causal: bool, window: int, device=None):
    """[Sq, Skv] bool validity (None without ``causal``): key j is valid for
    query i when j <= i + Skv - Sq and, with ``window``, i + Skv - Sq - j
    < window."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def attention_scores(q, k):
    """q [B, H, Sq, D], k [B, KV, Skv, D] -> f32 scores [B, KV, H / KV, Sq,
    Skv]: the products in f32 on upcast operands, times d^-1/2 in f32."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, sq, d).to(torch.float32)
    return torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d ** -0.5


def int_attention_ref(q, k, v, cfg: PrecisionConfig, causal: bool = True,
                      window: int = 0, return_rows: bool = False):
    """q [B, H, Sq, D]; k, v [B, KV, Skv, D] (H % KV == 0), one dtype ->
    [B, H, Sq, D] float32. With ``return_rows`` also the f32 scores and
    probabilities, [B * H, Sq, Skv] each."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scores = attention_scores(q, k)
    mask = attention_mask(sq, skv, causal, window, device=q.device)
    probs = int_softmax_block(scores, mask, cfg)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).reshape(b, h, sq, d)
    if not return_rows:
        return out
    return out, scores.reshape(b * h, sq, skv), probs.reshape(b * h, sq, skv)


def k3_span(r0: int, nr: int, sq: int, skv: int, causal: bool, window: int):
    """Keys ``[lo, hi)`` some row of query rows ``[r0, r0 + nr)`` attends:
    every key without ``causal``; else up to the largest row position and,
    with ``window``, from the smallest position - window + 1. Rows at
    negative positions (Sq > Skv) see no key; the span of the others is
    one interval, so every key in it is valid for some row."""
    if not causal:
        return 0, skv
    shift = skv - sq
    hi = max(0, min(skv, r0 + nr + shift))
    lo = min(hi, max(0, r0 + shift - window + 1)) if window else 0
    return lo, hi


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """One launch of K3: ``q_tile`` query rows a CTA, ``k_tile`` keys a
    tile; ``key_tiles[i]`` the key tiles ``[first, end)`` query tile ``i``
    visits (empty where no row of it attends a key)."""

    q_tile: int
    k_tile: int
    key_tiles: tuple

    def ctas(self, bh: int) -> int:
        return bh * len(self.key_tiles)

    @property
    def tiles_visited(self) -> int:
        """(query tile, key tile) pairs one head visits, each three times."""
        return sum(b - a for a, b in self.key_tiles)

    def visited(self, sq: int, skv: int, device=None):
        """[Sq, Skv] bool: the (query, key) pairs inside a visited tile."""
        out = torch.zeros((sq, skv), dtype=torch.bool, device=device)
        for i, (a, b) in enumerate(self.key_tiles):
            out[i * self.q_tile:(i + 1) * self.q_tile, a * self.k_tile:b * self.k_tile] = True
        return out


def k3_plan(sq: int, skv: int, causal: bool, window: int = 0, q_tile: int = 64,
            k_tile: int = 64) -> K3Plan:
    """K3's launch for ``sq`` queries on ``skv`` keys: one CTA per query tile
    (and head), each over the key tiles holding its ``k3_span``."""
    tiles = []
    for r0 in range(0, sq, q_tile):
        lo, hi = k3_span(r0, min(q_tile, sq - r0), sq, skv, causal, window)
        first = lo // k_tile
        tiles.append((first, -(-hi // k_tile)) if hi > lo else (first, first))
    return K3Plan(q_tile, k_tile, tuple(tiles))


def k3_smem_bytes(d: int, dtype, m: int) -> int:
    """Dynamic shared memory of one K3 CTA (``csrc/int_attention.cu:
    smem_bytes``): two K and two V tiles of the kernel's keys and the exp
    table of the 2^(M-1) + 1 codes for M <= 14. On the TMA path the tiles
    are boxes, d padded to 16 and no more, behind up to 128 bytes of
    alignment, with two 8-byte mbarriers, and Q (64 or 128 rows) is staged
    in the V slots;
    else each staged row is d padded to 16 plus 16 bytes, and Q has its own
    64 rows. It does not depend on the number of keys."""
    esz = torch.finfo(dtype).bits // 8
    d16 = -(-d // 16) * 16
    keys = 16 if dtype == torch.float32 else 64
    table = (2 ** (m - 1) + 1) * 4 if m <= K3_MAX_TABLE_M else 0
    if dtype == torch.bfloat16 and d <= K3_TMA_MAX_D:
        return 128 + 4 * keys * d16 * esz + 16 + table
    return (4 * keys + 64) * (d16 * esz + 16) + table


def int_attention_tiled(q, k, v, cfg: PrecisionConfig, causal: bool = True,
                        window: int = 0, q_tile: int = 64, k_tile: int = 64,
                        return_rows: bool = False):
    """``int_attention_ref`` in the kernel's passes over ``k3_plan``: for each
    query tile, Alg. 1 over its visited key tiles (tile maxima, then int64
    tile sums, then the division: ``int_softmax_split_ref`` with the key
    tiles as chunks), and PV as one f32 partial a key tile, the partials
    added in key order (``combine_partials``). Its scores and probabilities
    equal ``int_attention_ref``'s bit for bit; its outputs differ in the
    order of the f32 sums."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    bh = b * h
    scores = attention_scores(q, k).reshape(bh, sq, skv)
    mask = attention_mask(sq, skv, causal, window, device=q.device)
    valid = (torch.ones((sq, skv), dtype=torch.bool, device=q.device) if mask is None
             else mask)
    vg = v.to(torch.float32)[:, :, None].expand(b, kv, h // kv, skv, d).reshape(bh, skv, d)
    plan = k3_plan(sq, skv, causal, window, q_tile, k_tile)
    out = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    probs = torch.zeros((bh, sq, skv), dtype=torch.float32, device=q.device)
    for i, (t0, t1) in enumerate(plan.key_tiles):
        if t0 == t1:
            continue                                     # no key: the sum is empty
        r0, r1 = i * q_tile, min(sq, (i + 1) * q_tile)
        a, e = t0 * k_tile, min(t1 * k_tile, skv)
        x = scores[:, r0:r1, a:e]
        m = valid[r0:r1, a:e].expand_as(x)
        p = int_softmax_split_ref(x.reshape(-1, e - a), cfg, m.reshape(-1, e - a),
                                  k_tile).reshape(x.shape)
        probs[:, r0:r1, a:e] = p
        pr = p.to(v.dtype).to(torch.float32)
        out[:, r0:r1] = combine_partials(torch.stack([
            pr[..., c0:c1] @ vg[:, a + c0:a + c1] for c0, c1 in k1_chunks(e - a, k_tile)]))
    out = out.reshape(b, h, sq, d)
    if not return_rows:
        return out
    return out, scores, probs
