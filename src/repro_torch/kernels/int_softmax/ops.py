"""Wrapper of K1, the CUDA Alg.-1 softmax (``csrc/int_softmax.cu``).

Port of ``src/repro/kernels/int_softmax/ops.py:int_softmax_pallas`` (the
drop-in over arbitrary leading dims) and ``kernel.py:int_softmax_kernel``
(the ``[rows, cols]`` launch). A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises — there is no
fallback. The launch's layout is ``ref.k1_split_plan``'s.
``int_softmax_rows.launches`` counts kernel launches (one a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import BEST, PrecisionConfig
from repro_torch.kernels import build, count_launch
from repro_torch.kernels.int_softmax.ref import (
    K1_MAX_COLS, K1Plan, int_softmax_ref, k1_split_plan,
)

# Longest row: a cluster of 8 CTAs (portable on every Hopper card) of 512
# threads holding 32 elements each. cfg.max_seq of every supported model
# is <= 32768.
MAX_COLS = K1_MAX_COLS


class Alg1Consts(ctypes.Structure):
    """Mirror of ``struct Alg1Consts`` in ``csrc/alg1.cuh``: the offline
    constants of one PrecisionConfig."""

    _fields_ = [("M", ctypes.c_int), ("P_out", ctypes.c_int),
                ("v_ln2", ctypes.c_int), ("mu", ctypes.c_int),
                ("v_b", ctypes.c_int), ("v_c", ctypes.c_int),
                ("exp_shift", ctypes.c_int), ("vcorr_min", ctypes.c_int),
                ("poly_sat", ctypes.c_int), ("vapprox_sat", ctypes.c_int),
                ("sum_sat", ctypes.c_int),
                ("T_C", ctypes.c_float), ("S", ctypes.c_float)]


def alg1_consts(cfg: PrecisionConfig) -> Alg1Consts:
    def sat(width):
        return min(2 ** width - 1, 2 ** 31 - 1)
    return Alg1Consts(
        M=cfg.M, P_out=cfg.P_out, v_ln2=cfg.v_ln2, mu=cfg.mu, v_b=cfg.v_b,
        v_c=cfg.v_c, exp_shift=cfg.exp_shift,
        vcorr_min=-(2 ** (cfg.w_vcorr - 1)), poly_sat=sat(cfg.w_poly),
        vapprox_sat=sat(cfg.w_vapprox), sum_sat=cfg.sum_saturation,
        T_C=cfg.T_C, S=cfg.S)


def _library() -> ctypes.CDLL:
    lib = build.load("int_softmax")
    fn = lib.int_softmax_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, Alg1Consts, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


_plan = functools.lru_cache(maxsize=256)(k1_split_plan)


def launch_plan(x) -> K1Plan:
    """The layout K1 launches for CUDA scores ``x`` [rows, cols]."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _plan(*x.shape, sms)


def int_softmax_rows(x, cfg: PrecisionConfig, mask=None):
    """x: [rows, cols] float32 scores; mask: [rows, cols] uint8 (nonzero =
    valid) or None -> [rows, cols] float32 probabilities."""
    if not x.is_cuda:
        return int_softmax_ref(x, cfg, mask)
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("int_softmax_rows takes contiguous [rows, cols] "
                         f"float32, got {x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"row length {cols} outside [1, {MAX_COLS}]")
    if mask is not None and (mask.shape != x.shape or mask.dtype != torch.uint8
                             or mask.device != x.device
                             or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous uint8 tensor shaped like "
                         "x on x's device")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    plan = launch_plan(x)
    rc = _library().int_softmax_launch(
        x.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), rows, cols, plan.per_thread, plan.rows_per_cta,
        plan.cluster, alg1_consts(cfg), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int_softmax kernel launch failed: CUDA error {rc}")
    count_launch(int_softmax_rows)
    return out


int_softmax_rows.launches = 0


def int_softmax_cuda(x, cfg: PrecisionConfig = BEST, mask=None, axis: int = -1):
    """Drop-in Alg.-1 softmax over the last axis of ``x`` (any leading
    dims); ``mask`` is a bool tensor broadcastable to ``x``. Leading dims are
    flattened into rows and the mask is materialized as ``[rows, cols]``
    uint8; bf16/f16 scores widen to f32 exactly (the quantizer's first
    step)."""
    if axis not in (-1, x.ndim - 1):
        raise ValueError("int_softmax_cuda computes over the last axis")
    shape = x.shape
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    x2 = x.reshape(-1, shape[-1]).contiguous()
    m2 = None
    if mask is not None:
        m2 = torch.broadcast_to(mask, shape).reshape(-1, shape[-1])
        if x.is_cuda:
            m2 = m2.to(torch.bool).contiguous().view(torch.uint8)
    return int_softmax_rows(x2, cfg, m2).reshape(shape)
