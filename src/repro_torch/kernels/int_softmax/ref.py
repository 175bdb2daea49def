"""Plain PyTorch versions of K1, in the kernel's ``[rows, cols]`` layout.

``int_softmax_ref``: Alg. 1 with the bit-serial division
(``core.alg1.int_softmax_block``) — the body the reference's Pallas kernel
computes and the CUDA kernel reproduces bit for bit. The wrapper
(``ops.py``) runs it for CPU tensors; the chip smoke test holds the kernel
against it on the card.

The CUDA kernel (``csrc/int_softmax.cu``) launches the layout of
``k1_split_plan``: a warp a row for rows of up to ``K1_ROW_MAX_COLS``
columns, else a thread-block cluster a row, each CTA on one chunk of
columns (``k1_chunks``). ``int_softmax_split_ref(..., chunk_cols=n)``
mirrors its exact Alg.-1 passes: chunk maxima combined into the row max
(``split_row_max``), per-chunk int64 sums combined into the row sum
(``split_row_sum``) and clipped once, then the division by the row's
reciprocal (``fixedpoint_div_rowrcp``, the kernel's ``alg1_prob_row``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.alg1 import int_exp_codes, int_softmax_block
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantization import NEG_INF, dequantize_probs, quantize_against

# Rows layout: a warp a row, each lane holding one of K1_ROW_PER_LANE
# elements (registers), 1-8 rows a CTA. Split layout: a cluster of up to
# K1_MAX_CLUSTER CTAs a row (portable on every Hopper card), each of
# K1_SPLIT_THREADS threads holding one of K1_SPLIT_PER_THREAD elements.
K1_ROW_PER_LANE = (4, 8, 16, 32, 64)
K1_ROW_MAX_COLS = 32 * K1_ROW_PER_LANE[-1]
K1_MAX_ROWS_PER_CTA = 8
K1_SPLIT_THREADS = 512
K1_SPLIT_PER_THREAD = (4, 8, 16, 32)
K1_MAX_CLUSTER = 8
K1_MAX_COLS = K1_MAX_CLUSTER * K1_SPLIT_THREADS * K1_SPLIT_PER_THREAD[-1]
K1_MAX_M = 14               # largest M with an exp table (2^(M-1) + 1 int32 codes a CTA)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """One launch of K1. ``cluster`` 1: the rows layout (``rows_per_cta``
    warps a CTA, a row each); else the split layout (``cluster`` CTAs a
    row). ``per_thread`` elements a thread; ``chunk_cols`` columns a CTA's
    chunk of a row (the whole row in the rows layout)."""

    per_thread: int
    rows_per_cta: int
    cluster: int
    chunk_cols: int

    @property
    def layout(self) -> str:
        return "rows" if self.cluster == 1 else "split"


def k1_split_plan(rows: int, cols: int, sms: int) -> K1Plan:
    """K1's launch for ``[rows, cols]``. Rows of up to ``K1_ROW_MAX_COLS``:
    the fewest elements a lane that hold the row, and up to 8 rows a CTA,
    halved while the grid has fewer CTAs than ``sms``. Longer rows: the
    fewest elements a thread that let a cluster of at most
    ``K1_MAX_CLUSTER`` CTAs hold the row (so the most CTAs a row)."""
    if not 1 <= cols <= K1_MAX_COLS:
        raise ValueError(f"row length {cols} outside [1, {K1_MAX_COLS}]")
    if cols <= K1_ROW_MAX_COLS:
        e = next(e for e in K1_ROW_PER_LANE if 32 * e >= cols)
        rpc = K1_MAX_ROWS_PER_CTA
        while rpc > 1 and math.ceil(rows / rpc) < sms:
            rpc //= 2
        return K1Plan(e, rpc, 1, cols)
    for e in K1_SPLIT_PER_THREAD:
        chunk = K1_SPLIT_THREADS * e
        if math.ceil(cols / chunk) <= K1_MAX_CLUSTER:
            return K1Plan(e, 1, math.ceil(cols / chunk), chunk)


def k1_chunks(cols: int, chunk_cols: int):
    """The chunks ``[(first column, end column), ...]`` of a row, in order."""
    return [(a, min(a + chunk_cols, cols)) for a in range(0, cols, chunk_cols)]


def split_row_max(chunk_max):
    """[..., NC] per-chunk maxima over valid scores -> the max each chunk
    quantizes against: the row's, the same for every chunk."""
    return chunk_max.amax(-1, keepdim=True).expand_as(chunk_max)


def split_row_sum(chunk_sums):
    """[..., NC] exact int64 chunk sums -> the row's exact sum."""
    return chunk_sums.sum(-1)


def fixedpoint_div_rowrcp(num, den, frac_bits: int):
    """``min(floor(num 2^P / den), 2^P - 1)`` as K1 computes it
    (``alg1.cuh:alg1_prob_row``): ``R = floor(2^(P+32) / den)`` once per
    row, then 32-bit products and one remainder correction per element.
    int64 tensors ``0 <= num < 2^31``, ``1 <= den < 2^30``, ``P <= 30``;
    ``den`` broadcasts against ``num``. Returns int32 codes."""
    num, den = num.to(torch.int64), den.to(torch.int64)
    u32 = 0xFFFFFFFF
    r = (1 << (frac_bits + 32)) // den
    r_hi, r_lo = r >> 32, r & u32
    q = (num * r_hi + ((num * r_lo) >> 32)) & u32
    rem = ((num << frac_bits) - q * den) & u32
    q = q + (rem >= den).to(torch.int64)
    top = 2 ** frac_bits - 1
    return torch.where(num >= den, top, q).to(torch.int32)


def int_softmax_ref(x, cfg: PrecisionConfig, mask=None):
    """x: [rows, cols] float scores; mask: [rows, cols] (nonzero = valid) or
    None -> [rows, cols] float32 probabilities."""
    if x.ndim != 2:
        raise ValueError(f"expected [rows, cols] scores, got {tuple(x.shape)}")
    m = None if mask is None else mask != 0
    return int_softmax_block(x, m, cfg).to(torch.float32)


def int_softmax_split_ref(x, cfg: PrecisionConfig, mask=None, chunk_cols=None):
    """Alg. 1 over K1's chunks of ``chunk_cols`` columns (None: the whole
    row), in the kernel's passes; equals ``int_softmax_ref`` bit for bit."""
    if x.ndim != 2:
        raise ValueError(f"expected [rows, cols] scores, got {tuple(x.shape)}")
    x = x.to(torch.float32)
    valid = torch.ones_like(x, dtype=torch.bool) if mask is None else mask != 0
    chunks = k1_chunks(x.shape[1], chunk_cols or x.shape[1])
    cmax = torch.stack([torch.where(valid[:, a:b], x[:, a:b], NEG_INF).amax(-1)
                        for a, b in chunks], -1)            # [rows, NC]
    mrow = split_row_max(cmax)
    codes, sums = [], []
    for c, (a, b) in enumerate(chunks):
        m = mrow[:, c:c + 1]
        mu = torch.where(m <= NEG_INF, 0.0, m)
        vmax = quantize_against(m, mu, cfg)                 # 0 unless guarded
        va = int_exp_codes(quantize_against(x[:, a:b], mu, cfg) - vmax, cfg)
        va = torch.where(valid[:, a:b], va, 0)
        codes.append(va)
        sums.append(va.sum(-1, dtype=torch.int64))
    total = split_row_sum(torch.stack(sums, -1)).clamp(1, cfg.sum_saturation)[:, None]
    return torch.cat([dequantize_probs(fixedpoint_div_rowrcp(va, total, cfg.P_out), cfg)
                      for va in codes], -1)
