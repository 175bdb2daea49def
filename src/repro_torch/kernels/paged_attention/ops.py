"""Wrapper of K2, the CUDA fused paged decode (``csrc/paged_attention.cu``).

Port of ``src/repro/kernels/paged_attention/ops.py:paged_attend_dense``
(the model-to-kernel reshapes: rows are ``t * group + g``) and
``kernel.py:paged_attention_dense`` (the ``[S, KV, ROWS, D]`` launch). A
CPU or meta tensor takes the plain version (``ref.py``) — the cost meter
runs the model on ``meta`` — and a CUDA tensor launches the kernel or
raises: there is no fallback. ``paged_attention_rows.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.kernels import build
from repro_torch.kernels.int_softmax.ops import Alg1Consts, alg1_consts
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

MAX_D = 256

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SCORE_DTYPES = (torch.float32, torch.bfloat16)


class PagedShape(ctypes.Structure):
    """Mirror of ``struct PagedShape`` in ``csrc/paged_attention.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "KV", "rows", "group", "T", "D", "Dv", "NB", "BS", "NLOG",
        "window", "scores_bf16")] + [("scale", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, PagedShape, Alg1Consts,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lim = lib.paged_attention_smem_limit
    lim.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lim.restype = ctypes.c_int
    return lib


def smem_bytes(rows: int, l_full: int, d: int) -> int:
    """Dynamic shared memory of one CTA: the scores of all rows over the
    whole logical row, plus q, as f32."""
    return 4 * rows * (l_full + d)


def smem_limit(dtype) -> int:
    """The dynamic shared memory a CTA may take on the current card, as
    the kernel library computes it (the opt-in limit less its static
    scratch)."""
    limit = ctypes.c_int(0)
    rc = _library().paged_attention_smem_limit(_DTYPES[dtype], ctypes.byref(limit))
    if rc != 0:
        raise RuntimeError(f"paged_attention shared-memory query failed: CUDA error {rc}")
    return limit.value


def paged_attention_rows(q, k_pool, v_pool, table, positions,
                         cfg: PrecisionConfig, *, scale: float, window: int = 0,
                         scores_dtype=torch.float32, scores_out=None,
                         probs_out=None):
    """q [S, KV, ROWS, D]; pools [NB, BS, KV, D] in q's dtype (bf16 or f32);
    table [S, NLOG] int32; positions [S, T] int32 -> out [S, KV, ROWS, Dv].
    ``scores_out`` / ``probs_out``: optional f32 [S, KV, ROWS, NLOG * BS]
    tensors the kernel fills with the scores and Alg.-1 probabilities of
    the pages it visits (zero them first; the chip smoke test's check)."""
    if q.device.type != "cuda":
        debug = scores_out is not None or probs_out is not None
        res = paged_attention_ref(
            q, k_pool, v_pool, table, positions, cfg, scale=scale,
            window=window, scores_dtype=scores_dtype, return_rows=debug)
        if not debug:
            return res
        out, scores, probs = res
        for dst, src in ((scores_out, scores), (probs_out, probs)):
            if dst is not None:
                dst.copy_(src)
        return out
    s_, kvh, rows, d = q.shape
    nb, bs = k_pool.shape[:2]
    nlog, t = table.shape[1], positions.shape[1]
    dv = v_pool.shape[-1]
    tensors = (q, k_pool, v_pool, table, positions)
    if any(not x.is_cuda or x.device != q.device or not x.is_contiguous()
           for x in tensors):
        raise ValueError("paged_attention_rows takes contiguous tensors on one card")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share bf16 or f32, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("table and positions must be int32")
    if scores_dtype not in _SCORE_DTYPES:
        raise ValueError(f"scores dtype {scores_dtype} is not f32 or bf16")
    if (k_pool.shape != (nb, bs, kvh, d) or v_pool.shape[:3] != (nb, bs, kvh)
            or table.shape[0] != s_ or positions.shape[0] != s_ or rows % t):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}, table {tuple(table.shape)}, positions "
            f"{tuple(positions.shape)}")
    if d > MAX_D:
        raise ValueError(f"head dim {d} > {MAX_D}")
    need, limit = smem_bytes(rows, nlog * bs, d), smem_limit(q.dtype)
    if need > limit:
        raise ValueError(
            f"paged decode of {rows} rows over {nlog * bs} positions needs "
            f"{need} B of shared memory > {limit} B; shorten the cache "
            "or the verify width")
    for dbg in (scores_out, probs_out):
        if dbg is not None and (dbg.shape != (s_, kvh, rows, nlog * bs)
                                or dbg.dtype != torch.float32
                                or dbg.device != q.device
                                or not dbg.is_contiguous()):
            raise ValueError("scores_out / probs_out must be contiguous f32 "
                             "[S, KV, ROWS, NLOG * BS] on q's card")
    out = torch.empty((s_, kvh, rows, dv), dtype=q.dtype, device=q.device)
    shape = PagedShape(S=s_, KV=kvh, rows=rows, group=rows // t, T=t, D=d, Dv=dv,
                       NB=nb, BS=bs, NLOG=nlog, window=window,
                       scores_bf16=int(scores_dtype == torch.bfloat16),
                       scale=scale)
    ptr = [x.data_ptr() for x in tensors] + [out.data_ptr()]
    ptr += [None if x is None else x.data_ptr() for x in (scores_out, probs_out)]
    rc = _library().paged_attention_launch(
        *ptr, _DTYPES[q.dtype], shape, alg1_consts(cfg),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    paged_attention_rows.launches += 1
    return out


paged_attention_rows.launches = 0


def paged_attend_dense(q, k_pool, v_pool, table, positions,
                       pcfg: PrecisionConfig, *, scale: float, window: int = 0,
                       k_scale=None, v_scale=None, scores_dtype=torch.float32):
    """q [B, T, H, D] (model layout) -> [B, T, H, Dv]. ``positions`` [B, T]
    are the absolute query positions (decode: the written ``cache_pos``)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV pools in the fused paged decode are not ported: "
            "ROADMAP.md Queue 1 item 8")
    b, t, h, d = q.shape
    kvh = k_pool.shape[2]
    dv = v_pool.shape[-1]
    group = h // kvh
    rows = t * group
    qk = q.reshape(b, t, kvh, group, d).permute(0, 2, 1, 3, 4)
    qk = qk.reshape(b, kvh, rows, d).contiguous()
    out = paged_attention_rows(qk, k_pool, v_pool, table,
                               positions.to(torch.int32).contiguous(), pcfg,
                               scale=scale, window=window,
                               scores_dtype=scores_dtype)
    out = out.reshape(b, kvh, t, group, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, dv)
