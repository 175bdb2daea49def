"""K1's split over CTAs, checked on the CPU through its plain split version.

The CUDA kernel (``csrc/int_softmax.cu``) launches ``ref.k1_split_plan``'s
layout: a warp a row for short rows, else a thread-block cluster a row, each
CTA on one chunk of columns (``k1_chunks``), in exact Alg.-1 passes: chunk
maxima combined into the row max, per-chunk int64 sums into the row sum,
then the division by the row's reciprocal (``alg1.cuh:alg1_prob_row``).
``int_softmax_split_ref(..., chunk_cols=n)`` mirrors that partition; these
tests hold it:

* bitwise equal to the whole-row plain version and to the JAX
  ``int_softmax_pallas`` in interpret mode (as
  ``tests/test_torch_int_softmax_kernel.py`` runs it), over chunks of 1
  column, odd sizes and the whole row, with all-masked, lone-element and
  sentinel rows, at ``BEST``, M=4 and a config whose sum saturates;
* the row-reciprocal division equal to ``//`` on edge numerators and
  divisors and a random sample;
* the plan: every column in exactly one chunk, in order, and each CTA's
  codes within its registers and its exp table within the 48 KB a block
  takes without an opt-in;
* the two faults ``chip_smoke.py --fault-control`` patches in are seen by
  the bitwise check.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import precision as jprec
from repro.kernels.int_softmax.ops import int_softmax_pallas
from repro_torch.core import precision as tprec
from repro_torch.core.alg1 import int_exp_codes
from repro_torch.core.quantization import quantize_against
from repro_torch.kernels.int_softmax import ref
from repro_torch.kernels.int_softmax.ref import (
    K1_MAX_CLUSTER, K1_MAX_COLS, K1_ROW_MAX_COLS, K1_SPLIT_PER_THREAD, K1_SPLIT_THREADS,
    fixedpoint_div_rowrcp, int_softmax_ref, int_softmax_split_ref, k1_chunks, k1_split_plan,
)

torch.set_num_threads(2)

SMEM_DEFAULT = 48 * 1024    # shared memory a block takes without an opt-in


def table_bytes(M):
    """Shared memory of a CTA's exp table (csrc/int_softmax.cu:table_bytes)."""
    return (2 ** (M - 1) + 1) * 4

# m15: above K1's exp table (M <= 14), so the kernel computes each exp
CFG_KW = {"best": dict(M=6, N=16, T_C=-7.0), "m4": dict(M=4, T_C=-4.0),
          "saturating": dict(M=6, N=0, T_C=-7.0),
          "m15": dict(M=15, T_C=-1.0, P_out_override=24)}
# scenario -> (rows, cols)
SCENARIOS = {"short": (6, 37), "odd long": (5, 301), "one column": (4, 1)}
CHUNKS = {"1 column": 1, "7 columns": 7, "64 columns": 64, "whole row": None}


@functools.lru_cache(maxsize=None)
def _case(scenario, cfg_name):
    """numpy inputs of a scenario (an all-masked row, a lone-element row,
    a row whose valid scores lie at the masking sentinel, random rows) and
    the reference's probabilities (JAX interpret mode)."""
    rows, cols = SCENARIOS[scenario]
    r = np.random.default_rng(sorted(SCENARIOS).index(scenario))
    x = (r.standard_normal((rows, cols)) * 3).astype(np.float32)
    m = r.random((rows, cols)) < 0.7
    m[0] = False                     # all masked
    m[1] = False
    m[1, cols // 2] = True           # a lone element: v_approx == total
    if rows > 4:
        x[2] = -1e30                 # the guarded max: every valid code on the floor
        x[2, ::2] = -2e30
    jc = jprec.PrecisionConfig(**CFG_KW[cfg_name])
    want = np.asarray(int_softmax_pallas(jnp.asarray(x), jc, mask=jnp.asarray(m)))
    return x, m, want


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("cfg_name", list(CFG_KW))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_split_bitwise_equal_to_whole_rows_and_pallas(scenario, cfg_name, chunk):
    x, m, want = _case(scenario, cfg_name)
    cfg = tprec.PrecisionConfig(**CFG_KW[cfg_name])
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    got = int_softmax_split_ref(tx, cfg, tm.to(torch.uint8), CHUNKS[chunk])
    assert got.dtype == torch.float32 and got.shape == tx.shape
    assert torch.equal(got, int_softmax_ref(tx, cfg, tm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0].abs().max()) == 0.0
    assert float(got[1].max()) == (2 ** cfg.P_out - 1) * 2.0 ** -cfg.P_out


def test_saturating_config_saturates():
    """The "saturating" cases above reach their sum's saturation."""
    x, m, _ = _case("odd long", "saturating")
    cfg = tprec.PrecisionConfig(**CFG_KW["saturating"])
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    mu = torch.where(tm, tx, -1e30).amax(-1, keepdim=True)
    va = torch.where(tm, int_exp_codes(quantize_against(tx, mu, cfg), cfg), 0)
    assert int(va.sum(-1, dtype=torch.int64).max()) > cfg.sum_saturation


def test_unmasked_split_rows():
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((3, 4500)) * 3).astype(np.float32))
    cfg = tprec.BEST
    whole = int_softmax_ref(x, cfg)
    for chunk in (2048, 1000, 4499):
        assert torch.equal(int_softmax_split_ref(x, cfg, None, chunk), whole)


def _div_cases(cfg):
    sat = cfg.sum_saturation
    vsat = min(2 ** cfg.w_vapprox - 1, 2 ** 31 - 1)
    totals = {1, 2, 3, sat}
    for k in range(1, 30):
        totals |= {2 ** k - 1, 2 ** k, 2 ** k + 1}
    totals = sorted(t for t in totals if 1 <= t <= sat)
    num, den = [], []
    for t in totals:
        for v in {0, 1, t - 1, t, t + 1, vsat}:
            if 0 <= v < 2 ** 31:
                num.append(v)
                den.append(t)
    rng = np.random.default_rng(cfg.P_out)
    dr = rng.integers(1, sat + 1, 20000)
    num += list(np.minimum(rng.integers(0, 2 ** 31, 20000) % (2 * dr), vsat))
    den += list(dr)
    num += list(rng.integers(0, vsat + 1, 20000))
    den += list(rng.integers(1, min(sat, 1 << 20) + 1, 20000))
    return (torch.tensor(num, dtype=torch.int64), torch.tensor(den, dtype=torch.int64))


@pytest.mark.parametrize("cfg_name", list(CFG_KW) + ["P 30"])
def test_row_reciprocal_division_equals_floor_division(cfg_name):
    cfg = (tprec.PrecisionConfig(M=6, P_out_override=30) if cfg_name == "P 30"
           else tprec.PrecisionConfig(**CFG_KW[cfg_name]))
    num, den = _div_cases(cfg)
    p = cfg.P_out
    want = torch.clamp_max((num << p) // den, 2 ** p - 1).to(torch.int32)
    assert torch.equal(fixedpoint_div_rowrcp(num, den, p), want)


# (rows, cols) of every phase-3 shape of chip_smoke.py and the plan's edges
PLANS = [(64, 544), (32768, 512), (64, 1), (256, 1000), (8, 32768), (1, 32768),
         (4, 32769), (4, 131072), (64, 543), (8, 1001), (16 * 16, 400), (8192, 512),
         (20480, 512), (5120, 512), (320, 544), (1, 2048), (3, 2049), (7, 33)]


# SMs of an H100 SXM and an H100 PCIe
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,cols", PLANS)
def test_split_plan_covers_each_column_once(rows, cols, sms):
    plan = k1_split_plan(rows, cols, sms)
    chunks = k1_chunks(cols, plan.chunk_cols)
    assert [j for a, b in chunks for j in range(a, b)] == list(range(cols))
    if cols <= K1_ROW_MAX_COLS:
        assert plan.layout == "rows" and plan.cluster == 1 and len(chunks) == 1
        assert 32 * plan.per_thread >= cols and (plan.per_thread == 4
                                                 or 16 * plan.per_thread < cols)
        assert plan.rows_per_cta in (1, 2, 4, 8)
        assert plan.rows_per_cta == 1 or -(-rows // plan.rows_per_cta) >= sms
    else:
        assert plan.layout == "split" and plan.rows_per_cta == 1
        assert plan.per_thread in K1_SPLIT_PER_THREAD
        assert plan.chunk_cols == K1_SPLIT_THREADS * plan.per_thread
        assert 2 <= plan.cluster == len(chunks) <= K1_MAX_CLUSTER
    # each thread's codes stay in its registers; the exp table fits
    assert plan.per_thread <= 64 and table_bytes(ref.K1_MAX_M) <= SMEM_DEFAULT


def test_split_plan_spreads_long_rows():
    """8 rows of 32768 take at least 64 CTAs of 512 threads, so at least 64
    SMs at a CTA an SM; K1_MAX_COLS runs on portable clusters of 8."""
    plan = k1_split_plan(8, 32768, 132)
    assert 8 * plan.cluster >= 64
    assert k1_split_plan(4, K1_MAX_COLS, 132).cluster == K1_MAX_CLUSTER == 8
    with pytest.raises(ValueError):
        k1_split_plan(1, K1_MAX_COLS + 1, 132)


def _faulty(attr, fn, x, cfg, m, chunk):
    saved = getattr(ref, attr)
    setattr(ref, attr, fn)
    try:
        return int_softmax_split_ref(x, cfg, m, chunk)
    finally:
        setattr(ref, attr, saved)


@pytest.mark.parametrize("fault", ["own chunk max", "dropped chunk sum"])
def test_split_faults_break_bitwise_equality(fault):
    """chip_smoke.py's two K1 faults: each chunk quantizing against its own
    max, and one chunk's sum dropped. The bitwise check sees both."""
    x, m, _ = _case("odd long", "best")
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    whole = int_softmax_ref(tx, tprec.BEST, tm)
    attr, fn = {"own chunk max": ("split_row_max", lambda c: c),
                "dropped chunk sum": ("split_row_sum", lambda s: s[..., :-1].sum(-1))}[fault]
    got = _faulty(attr, fn, tx, tprec.BEST, tm, 64)
    assert not torch.equal(got, whole)
