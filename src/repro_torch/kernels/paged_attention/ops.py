"""Wrappers of K2 and K4, the CUDA fused paged decodes
(``csrc/paged_attention.cu``, ``csrc/paged_attention_mla.cu``).

Port of ``src/repro/kernels/paged_attention/ops.py``: ``paged_attend_dense``
(the model-to-kernel reshapes: rows are ``t * group + g``) over
``kernel.py:paged_attention_dense`` (the ``[S, KV, ROWS, D]`` launch), and
``paged_attend_mla`` (rows ``t * H + h``) over
``kernel.py:paged_attention_mla`` (the ``[S, ROWS, R]`` launch). A CPU or
meta tensor takes the plain version (``ref.py``) — the cost meter runs the
model on ``meta`` — and a CUDA tensor launches the kernel or raises: there
is no fallback. ``paged_attention_rows.launches`` and
``paged_attention_mla_rows.launches`` count wrapper calls that launch their
kernel (one K2 call runs its two or three launches);
``paged_attention_rows.int8_launches`` counts those of K2 on int8 pools.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.kernels import build, count_launch
from repro_torch.kernels.int_softmax.ops import Alg1Consts, alg1_consts
from repro_torch.kernels.paged_attention.ref import (
    k2_row_group, k2_split_plan, k4_split_plan, paged_attention_mla_ref, paged_attention_ref,
)

MAX_D = 256
MAX_R, MAX_DR = 512, 64

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SCORE_DTYPES = (torch.float32, torch.bfloat16)


class PagedShape(ctypes.Structure):
    """Mirror of ``struct PagedShape`` in ``csrc/paged_attention.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "KV", "rows", "group", "T", "D", "Dv", "NB", "BS", "NLOG",
        "window", "scores_bf16", "quant", "chunk_pages", "row_group")] + [
        ("scale", ctypes.c_float)]


class MlaShape(ctypes.Structure):
    """Mirror of ``struct MlaShape`` in ``csrc/paged_attention_mla.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "rows", "heads", "T", "R", "DR", "NB", "BS", "NLOG", "chunk_pages")] + [
        ("scale", ctypes.c_float)]


# library -> (pointer arguments of ``<library>_launch``, its shape struct)
_LAUNCH = {"paged_attention": (11, PagedShape), "paged_attention_mla": (10, MlaShape)}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` loaded, with ``<name>_launch`` (the pointers, the
    dtype code, the shape, the Alg.-1 constants, the stream) and
    ``<name>_scratch_bytes`` (the shape) typed once."""
    lib = build.load(name)
    n_ptrs, shape_type = _LAUNCH[name]
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int, shape_type, Alg1Consts,
                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbytes = getattr(lib, f"{name}_scratch_bytes")
    nbytes.argtypes = [shape_type]
    nbytes.restype = ctypes.c_size_t
    return lib


def _scratch(name: str, shape, device) -> torch.Tensor:
    """The scratch one launch of ``name`` at ``shape`` needs, uninitialized
    (the kernels write every byte they read)."""
    nbytes = getattr(_library(name), f"{name}_scratch_bytes")(shape)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plain(ref, args, kw, scores_out, probs_out):
    """The plain version for CPU and meta tensors, filling the optional
    debug rows as the kernel does."""
    debug = scores_out is not None or probs_out is not None
    res = ref(*args, return_rows=debug, **kw)
    if not debug:
        return res
    out, scores, probs = res
    for dst, src in ((scores_out, scores), (probs_out, probs)):
        if dst is not None:
            dst.copy_(src)
    return out


def _check_inputs(name, tensors, floats, ints, debug, debug_shape, layout):
    """Contiguous tensors on one card; ``floats`` share bf16 or f32;
    ``ints`` are int32; the debug rows f32 ``debug_shape``."""
    dev = tensors[0].device
    if any(not x.is_cuda or x.device != dev or not x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} takes contiguous tensors on one card")
    if floats[0].dtype not in _DTYPES or any(x.dtype != floats[0].dtype for x in floats):
        raise ValueError(f"{name}: queries and pools must share bf16 or f32, got "
                         f"{[x.dtype for x in floats]}")
    if any(x.dtype != torch.int32 for x in ints):
        raise ValueError(f"{name}: table and positions must be int32")
    for dbg in debug:
        if dbg is not None and (dbg.shape != debug_shape or dbg.dtype != torch.float32
                                or dbg.device != dev or not dbg.is_contiguous()):
            raise ValueError(f"scores_out / probs_out must be contiguous f32 {layout} "
                             "on the queries' card")


def _launch(name, tensors, out, debug, shape, cfg: PrecisionConfig, scratch=()):
    ptr = [None if x is None else x.data_ptr() for x in tensors + (out,) + debug + scratch]
    rc = getattr(_library(name), f"{name}_launch")(
        *ptr, _DTYPES[out.dtype], shape, alg1_consts(cfg),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ------------------------------------------------------------- K2 (dense / GQA)


def paged_attention_rows(q, k_pool, v_pool, table, positions,
                         cfg: PrecisionConfig, *, scale: float, window: int = 0,
                         k_scale=None, v_scale=None, scores_dtype=torch.float32,
                         scores_out=None, probs_out=None):
    """q [S, KV, ROWS, D]; pools [NB, BS, KV, D] in q's dtype (bf16 or f32),
    or int8 codes with ``k_scale``/``v_scale`` [NB, BS, KV] f32 (each code
    times its scale in f32, rounded to q's dtype); table [S, NLOG] int32;
    positions [S, T] int32 -> out [S, KV, ROWS, Dv].
    ``scores_out`` / ``probs_out``: optional f32 [S, KV, ROWS, NLOG * BS]
    tensors the kernel fills with the scores and Alg.-1 probabilities of
    the pages it visits (zero them first; the chip smoke test's check).
    The kernel splits each row over ``k2_split_plan`` chunks of pages,
    planned for the decode step's rows (``rows // T``), so a verify block's
    row takes the chunks the decode step at its position takes, and a CTA
    takes ``k2_row_group`` rows of its chunk; the context is bounded by the
    scratch this call allocates, not by shared memory."""
    tensors = (q, k_pool, v_pool, table, positions)
    debug = (scores_out, probs_out)
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None or k_pool.dtype != torch.int8
                  or v_pool.dtype != torch.int8):
        raise ValueError("int8 pools take both k_scale and v_scale, and scales "
                         "take int8 pools")
    if q.device.type != "cuda":
        return _plain(paged_attention_ref, tensors + (cfg,),
                      dict(scale=scale, window=window, k_scale=k_scale, v_scale=v_scale,
                           scores_dtype=scores_dtype), *debug)
    s_, kvh, rows, d = q.shape
    nb, bs = k_pool.shape[:2]
    nlog, t = table.shape[1], positions.shape[1]
    dv = v_pool.shape[-1]
    _check_inputs("paged_attention_rows", tensors + ((k_scale, v_scale) if quant else ()),
                  (q,) if quant else (q, k_pool, v_pool), (table, positions),
                  debug, (s_, kvh, rows, nlog * bs), "[S, KV, ROWS, NLOG * BS]")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                  or k_scale.shape != (nb, bs, kvh) or v_scale.shape != (nb, bs, kvh)):
        raise ValueError(f"scales must be f32 [NB, BS, KV] = {(nb, bs, kvh)}, got "
                         f"{tuple(k_scale.shape)} {k_scale.dtype} and "
                         f"{tuple(v_scale.shape)} {v_scale.dtype}")
    if scores_dtype not in _SCORE_DTYPES:
        raise ValueError(f"scores dtype {scores_dtype} is not f32 or bf16")
    if (k_pool.shape != (nb, bs, kvh, d) or v_pool.shape[:3] != (nb, bs, kvh)
            or table.shape[0] != s_ or positions.shape[0] != s_ or rows % t):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}, table {tuple(table.shape)}, positions "
            f"{tuple(positions.shape)}")
    esz = k_pool.element_size()
    if d > MAX_D or dv > MAX_D or (d * esz) % 16 or (dv * esz) % 16:
        raise ValueError(f"head dims {d} and {dv} must be within {MAX_D} with rows of "
                         f"a multiple of 16 bytes ({esz} B a value)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    cp = k2_split_plan(s_, kvh, rows, nlog, bs, _sm_count(q.device.index), t)
    shape = PagedShape(S=s_, KV=kvh, rows=rows, group=rows // t, T=t, D=d, Dv=dv,
                       NB=nb, BS=bs, NLOG=nlog, window=window,
                       scores_bf16=int(scores_dtype == torch.bfloat16), quant=int(quant),
                       chunk_pages=cp, row_group=k2_row_group(rows, cp, bs), scale=scale)
    out = torch.empty((s_, kvh, rows, dv), dtype=q.dtype, device=q.device)
    # scores, chunk maxima, sums and PV partials
    _launch("paged_attention", (q, k_pool, v_pool, k_scale, v_scale, table, positions),
            out, debug, shape, cfg, (_scratch("paged_attention", shape, q.device),))
    count_launch(paged_attention_rows)
    if quant:
        count_launch(paged_attention_rows, "int8_launches")
    return out


paged_attention_rows.launches = 0
paged_attention_rows.int8_launches = 0


def paged_attend_dense(q, k_pool, v_pool, table, positions,
                       pcfg: PrecisionConfig, *, scale: float, window: int = 0,
                       k_scale=None, v_scale=None, scores_dtype=torch.float32):
    """q [B, T, H, D] (model layout) -> [B, T, H, Dv]. ``positions`` [B, T]
    are the absolute query positions (decode: the written ``cache_pos``).
    An int8 pool rides with ``k_scale``/``v_scale`` [NB, BS, KV]."""
    b, t, h, d = q.shape
    kvh = k_pool.shape[2]
    dv = v_pool.shape[-1]
    group = h // kvh
    rows = t * group
    qk = q.reshape(b, t, kvh, group, d).permute(0, 2, 1, 3, 4)
    qk = qk.reshape(b, kvh, rows, d).contiguous()
    out = paged_attention_rows(qk, k_pool, v_pool, table,
                               positions.to(torch.int32).contiguous(), pcfg,
                               scale=scale, window=window, k_scale=k_scale,
                               v_scale=v_scale, scores_dtype=scores_dtype)
    out = out.reshape(b, kvh, t, group, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, dv)


# ------------------------------------------------------------------ K4 (MLA)


def paged_attention_mla_rows(q_lat, q_rope, c_pool, kr_pool, table, positions,
                             cfg: PrecisionConfig, *, scale: float, scores_out=None,
                             probs_out=None):
    """q_lat [S, ROWS, R], q_rope [S, ROWS, DR] (row ``t * H + h``); pools c
    [NB, BS, R] and kr [NB, BS, DR] in q's dtype (bf16 or f32); table [S,
    NLOG] int32; positions [S, T] int32 -> o_lat [S, ROWS, R].
    ``scores_out`` / ``probs_out``: optional f32 [S, ROWS, NLOG * BS]
    tensors the kernel fills with the scores and Alg.-1 probabilities of
    the pages it visits (zero them first; the chip smoke test's check).
    The kernel splits each row over ``k4_split_plan`` chunks of pages,
    planned for the decode step's rows (``rows // T``, the heads) as K2's;
    the context is bounded by the scratch this call allocates, not by
    shared memory."""
    tensors = (q_lat, q_rope, c_pool, kr_pool, table, positions)
    debug = (scores_out, probs_out)
    if q_lat.device.type != "cuda":
        return _plain(paged_attention_mla_ref, tensors + (cfg,), dict(scale=scale), *debug)
    s_, rows, r = q_lat.shape
    dr = q_rope.shape[-1]
    nb, bs = c_pool.shape[:2]
    nlog, t = table.shape[1], positions.shape[1]
    _check_inputs("paged_attention_mla_rows", tensors, (q_lat, q_rope, c_pool, kr_pool),
                  (table, positions), debug, (s_, rows, nlog * bs), "[S, ROWS, NLOG * BS]")
    if (q_rope.shape[:2] != (s_, rows) or c_pool.shape != (nb, bs, r)
            or kr_pool.shape != (nb, bs, dr) or table.shape[0] != s_
            or positions.shape[0] != s_ or rows % t):
        raise ValueError(
            f"shapes do not match: q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, c {tuple(c_pool.shape)}, kr {tuple(kr_pool.shape)}, "
            f"table {tuple(table.shape)}, positions {tuple(positions.shape)}")
    if r > MAX_R or dr > MAX_DR or r % 8 or dr % 8:
        raise ValueError(f"latent rank {r} and rope dim {dr} must be multiples of 8 "
                         f"within {MAX_R} and {MAX_DR}")
    if any(x.data_ptr() % 16 for x in (q_lat, q_rope, c_pool, kr_pool)):
        raise ValueError("the queries and latent pools must be 16-byte aligned")
    cp = k4_split_plan(s_, rows, nlog, bs, _sm_count(q_lat.device.index), t)
    shape = MlaShape(S=s_, rows=rows, heads=rows // t, T=t, R=r, DR=dr, NB=nb, BS=bs,
                     NLOG=nlog, chunk_pages=cp, scale=scale)
    out = torch.empty((s_, rows, r), dtype=q_lat.dtype, device=q_lat.device)
    # scores, chunk maxima, sums and PV partials
    _launch("paged_attention_mla", tensors, out, debug, shape, cfg,
            (_scratch("paged_attention_mla", shape, q_lat.device),))
    count_launch(paged_attention_mla_rows)
    return out


paged_attention_mla_rows.launches = 0


def paged_attend_mla(q_lat, q_rope, c_pool, kr_pool, table, positions,
                     pcfg: PrecisionConfig, *, scale: float):
    """q_lat [B, T, H, R], q_rope [B, T, H, DR] (model layout) -> o_lat [B, T,
    H, R]. ``W_uv`` and the output projection stay with the caller, shared
    with the gather path."""
    b, t, h, r = q_lat.shape
    out = paged_attention_mla_rows(
        q_lat.reshape(b, t * h, r).contiguous(),
        q_rope.reshape(b, t * h, q_rope.shape[-1]).contiguous(), c_pool, kr_pool, table,
        positions.to(torch.int32).contiguous(), pcfg, scale=scale)
    return out.reshape(b, t, h, r)
