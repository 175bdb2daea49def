"""Wrapper of K3, the CUDA fused prefill attention (``csrc/int_attention.cu``).

Port of ``src/repro/kernels/int_attention/ops.py:int_attention_pallas``
(model layout ``[B, H, S, D]``) over ``kernel.py:int_attention_kernel``
(the ``[B * H, Sq, D]`` launch). A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises: there is no
fallback. ``int_attention_rows.launches`` counts kernel launches. The model
does not call K3 (nor does the reference's): it is a stand-alone op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.kernels import build
from repro_torch.kernels.int_attention.ref import int_attention_ref
from repro_torch.kernels.int_softmax.ops import Alg1Consts, alg1_consts

MAX_D, MAX_ROW_TILE = 256, 16

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


class AttnShape(ctypes.Structure):
    """Mirror of ``struct AttnShape`` in ``csrc/int_attention.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "BH", "group", "Sq", "Skv", "D", "causal", "window", "row_tile")] + [
        ("scale", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/int_attention.cu`` loaded, its two entry points typed once."""
    lib = build.load("int_attention")
    lib.int_attention_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, AttnShape, Alg1Consts, ctypes.c_void_p]
    lib.int_attention_launch.restype = ctypes.c_int
    lib.int_attention_smem_limit.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.int_attention_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_limit(device: int, dtype) -> int:
    """The dynamic shared memory a K3 CTA may take on card ``device``, as the
    library computes it (the opt-in limit less its static scratch)."""
    limit = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _library().int_attention_smem_limit(_DTYPES[dtype], ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"int_attention shared-memory query failed: CUDA error {rc}")
    return limit.value


def row_tile(sq: int, bh: int, skv: int, d: int, limit: int, sms: int) -> int:
    """Query rows per K3 CTA, a power of two (the kernel's template
    parameter): the largest that still lets the grid (B*H x row tiles)
    cover the ``sms`` SMs, at most ``MAX_ROW_TILE``, and at most what fits
    ``limit`` bytes of shared memory (each row keeps its f32 scores over
    all ``skv`` keys and its f32 query). Raises when one row does not
    fit."""
    per_row = 4 * (skv + d)
    if limit < per_row:
        raise ValueError(
            f"fused prefill attention over {skv} keys needs {per_row} B of shared "
            f"memory for one query row > {limit} B; split the keys")
    most = min(MAX_ROW_TILE, limit // per_row, sq, -(-sq * bh // sms))
    return 1 << (max(most, 1).bit_length() - 1)


def int_attention_rows(q, k, v, cfg: PrecisionConfig, *, causal: bool = True,
                       window: int = 0, scores_out=None, probs_out=None):
    """q [BH, Sq, D]; k, v [BKV, Skv, D] in q's dtype (bf16 or f32), BH a
    multiple of BKV (row bh reads kv row bh // (BH / BKV)) -> f32 [BH, Sq,
    D]. ``scores_out`` / ``probs_out``: optional f32 [BH, Sq, Skv] tensors
    the kernel fills with the scores and Alg.-1 probabilities of the keys
    it visits (zero them first; the chip smoke test's check)."""
    bh, sq, d = q.shape
    bkv, skv = k.shape[:2]
    if k.shape != (bkv, skv, d) or v.shape != (bkv, skv, d) or bkv < 1 or bh % bkv:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    debug = (scores_out, probs_out)
    if q.device.type != "cuda":
        res = int_attention_ref(q[None], k[None], v[None], cfg, causal, window,
                                return_rows=any(x is not None for x in debug))
        if not isinstance(res, tuple):
            return res[0]
        for dst, src in zip(debug, res[1:]):
            if dst is not None:
                dst.copy_(src)
        return res[0][0]
    dev = q.device
    if any(not x.is_cuda or x.device != dev or not x.is_contiguous() for x in (q, k, v)):
        raise ValueError("int_attention_rows takes contiguous tensors on one card")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share bf16 or f32, got "
                         f"{[x.dtype for x in (q, k, v)]}")
    if d > MAX_D or d % 8:
        raise ValueError(f"head dim {d} must be a multiple of 8 within {MAX_D}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    for dbg in debug:
        if dbg is not None and (dbg.shape != (bh, sq, skv) or dbg.dtype != torch.float32
                                or dbg.device != dev or not dbg.is_contiguous()):
            raise ValueError("scores_out / probs_out must be contiguous f32 [BH, Sq, Skv] "
                             "on the queries' card")
    tile = row_tile(sq, bh, skv, d, smem_limit(dev.index, q.dtype),
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    shape = AttnShape(BH=bh, group=bh // bkv, Sq=sq, Skv=skv, D=d, causal=int(causal),
                      window=window if causal else 0, row_tile=tile, scale=d ** -0.5)
    ptr = [None if x is None else x.data_ptr() for x in (q, k, v, out) + debug]
    rc = _library().int_attention_launch(*ptr, _DTYPES[q.dtype], shape, alg1_consts(cfg),
                                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int_attention kernel launch failed: CUDA error {rc}")
    int_attention_rows.launches += 1
    return out


int_attention_rows.launches = 0


def int_attention(q, k, v, cfg: PrecisionConfig = BEST, causal: bool = True,
                  window: int = 0):
    """q [B, H, Sq, D]; k, v [B, KV, Skv, D] -> [B, H, Sq, D] float32: the
    fused QK^T -> Alg. 1 -> PV of ``int_attention_pallas``."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} kv heads")
    out = int_attention_rows(q.reshape(b * h, sq, d).contiguous(),
                             k.reshape(b * kv, skv, d).contiguous(),
                             v.reshape(b * kv, skv, d).contiguous(), cfg,
                             causal=causal, window=window)
    return out.reshape(b, h, sq, d)
