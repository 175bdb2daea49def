"""Wrapper of K3, the CUDA fused prefill attention (``csrc/int_attention.cu``).

Port of ``src/repro/kernels/int_attention/ops.py:int_attention_pallas``
(model layout ``[B, H, S, D]``) over ``kernel.py:int_attention_kernel``
(the ``[B * H, Sq, D]`` launch). A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises: there is no
fallback. The kernel runs one CTA per (head, tile of query rows) over the
key tiles of ``ref.k3_plan`` (tiles of ``ref.k3_tiles``); its shared memory
depends on d alone, so the context has no cap. ``int_attention_rows.launches`` counts kernel
launches. The model does not call K3 (nor does the reference's): it is a
stand-alone op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.kernels import build, count_launch
from repro_torch.kernels.int_attention.ref import K3_MAX_D, int_attention_ref, k3_tiles
from repro_torch.kernels.int_softmax.ops import Alg1Consts, alg1_consts

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


class AttnShape(ctypes.Structure):
    """Mirror of ``struct AttnShape`` in ``csrc/int_attention.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "BH", "group", "Sq", "Skv", "D", "causal", "window", "q_tile", "k_tile")] + [
        ("scale", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/int_attention.cu`` loaded, its entry points typed once."""
    lib = build.load("int_attention")
    lib.int_attention_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, AttnShape, Alg1Consts, ctypes.c_void_p]
    lib.int_attention_launch.restype = ctypes.c_int
    lib.int_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.int_attention_smem_bytes.restype = ctypes.c_size_t
    lib.int_attention_check_division.argtypes = [Alg1Consts, ctypes.c_void_p, ctypes.c_void_p]
    lib.int_attention_check_division.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(dtype, d: int, m: int) -> int:
    """The dynamic shared memory of one K3 CTA as the library computes it
    (``chip_smoke.py`` holds it against ``ref.k3_smem_bytes``)."""
    return _library().int_attention_smem_bytes(_DTYPES[dtype], d, m)


def division_mismatches(cfg: PrecisionConfig, device=None) -> int:
    """How many f32 values x - m in [T_C, 0] get another exp index from the
    kernel's branch-free division by S than from IEEE division
    (``alg1.cuh:alg1_exp_index_rcp`` against ``alg1_exp_index``), counted
    over all of them on the card. ``chip_smoke.py`` requires 0."""
    count = torch.zeros(1, dtype=torch.int64, device=device or "cuda")
    rc = _library().int_attention_check_division(
        alg1_consts(cfg), count.data_ptr(), torch.cuda.current_stream(count.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int_attention division check failed: CUDA error {rc}")
    return int(count.item())


def int_attention_rows(q, k, v, cfg: PrecisionConfig, *, causal: bool = True,
                       window: int = 0, scores_out=None, probs_out=None):
    """q [BH, Sq, D]; k, v [BKV, Skv, D] in q's dtype (bf16 or f32), BH a
    multiple of BKV (row bh reads kv row bh // (BH / BKV)) -> f32 [BH, Sq,
    D]. ``scores_out`` / ``probs_out``: optional f32 [BH, Sq, Skv] tensors
    the kernel fills with the scores and Alg.-1 probabilities of the key
    tiles it visits (zero them first; the chip smoke test's check)."""
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
    if d > K3_MAX_D or d % 8:
        raise ValueError(f"head dim {d} must be a multiple of 8 within {K3_MAX_D}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    for dbg in debug:
        if dbg is not None and (dbg.shape != (bh, sq, skv) or dbg.dtype != torch.float32
                                or dbg.device != dev or not dbg.is_contiguous()):
            raise ValueError("scores_out / probs_out must be contiguous f32 [BH, Sq, Skv] "
                             "on the queries' card")
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    q_tile, k_tile = k3_tiles(q.dtype, d, bh, sq, _sms(dev.index))
    shape = AttnShape(BH=bh, group=bh // bkv, Sq=sq, Skv=skv, D=d, causal=int(causal),
                      window=window if causal else 0, q_tile=q_tile, k_tile=k_tile,
                      scale=d ** -0.5)
    ptr = [None if x is None else x.data_ptr() for x in (q, k, v, out) + debug]
    rc = _library().int_attention_launch(*ptr, _DTYPES[q.dtype], shape, alg1_consts(cfg),
                                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int_attention kernel launch failed: CUDA error {rc}")
    count_launch(int_attention_rows)
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
