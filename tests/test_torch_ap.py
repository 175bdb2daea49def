"""The port's associative-processor modules (``ap/isa.py``,
``ap/functional_sim.py``, ``ap/dataflow.py``, ``ap/gpu_model.py``,
``ap/pipeline.py``) and the ``ap_sim`` backend, against the reference's
(mirroring ``tests/test_ap.py``, without its hypothesis properties).

Everything here is integer numpy or Python arithmetic on both sides, so it
is held bitwise / exactly: the LUT passes, the Fig.-5 program's codes (also
against the port's own plain torch Alg. 1, ``core.alg1``), its cycle log,
and every number of ``compare_point`` / ``sweep`` / ``summarize`` (the
paper's AP-vs-GPU evaluation over ``gpu_model``'s analytic A100 and
RTX3090 baselines)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ap import cost_model as jcm
from repro.ap import dataflow as jdf
from repro.ap import gpu_model as jgm
from repro.ap import pipeline as jpipe
from repro.backends import get_backend as jget_backend
from repro.core import PrecisionConfig as JPC
from repro.core import int_softmax_from_codes as j_from_codes
from repro.core.quantization import quantize_stable_scores as j_quantize
from repro_torch.ap import cost_model as cm
from repro_torch.ap import dataflow, gpu_model, pipeline
from repro_torch.ap.isa import CAM, lut_add, lut_sub
from repro_torch.backends import get_backend
from repro_torch.core.alg1 import int_softmax_from_codes
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.quantization import quantize_stable_scores

torch.set_num_threads(2)

# the (M, N, e) grid of tests/test_ap.py's dataflow test
GRID = [(6, 16, 0), (8, 12, 1), (4, 8, 0), (6, 8, 2), (8, 20, 0)]


def test_lut_add_bit_exact():
    rng = np.random.default_rng(0)
    W = 12
    cam = CAM(rows=256, bits=32)
    cam.alloc("a", W)
    cam.alloc("b", W)
    cam.alloc("carry", 1)
    a = rng.integers(0, 2 ** (W - 1), 256)
    b = rng.integers(0, 2 ** (W - 1), 256)
    cam.load("a", a)
    cam.load("b", b)
    lut_add(cam, "a", "b")
    assert np.array_equal(cam.read("a"), (a + b) % 2 ** W)
    # 4 compare + 4 write passes per bit == the Table-II "8M" term
    assert cam.compares == 4 * W and cam.writes == 4 * W + 1  # +1 carry clear


def test_lut_sub_bit_exact():
    rng = np.random.default_rng(1)
    W = 10
    cam = CAM(rows=128, bits=32)
    cam.alloc("a", W)
    cam.alloc("b", W)
    cam.alloc("carry", 1)
    a = rng.integers(0, 2 ** (W - 1), 128)
    b = rng.integers(0, 2 ** (W - 1), 128)
    cam.load("a", a)
    cam.load("b", b)
    lut_sub(cam, "a", "b")
    assert np.array_equal(cam.read("a", signed=True), a - b)


@pytest.mark.parametrize("M,N,e", GRID)
def test_dataflow_bitwise(M, N, e):
    """The port's Fig.-5 program: codes equal to the reference's program and
    to the port's plain torch Alg. 1 on the same codes, bitwise, with the
    same per-step cycle log."""
    kw = dict(M=M, N=N, v_corr_extra=e, T_C=-4.0 if M == 4 else -7.0)
    jcfg, cfg = JPC(**kw), PrecisionConfig(**kw)
    rng = np.random.default_rng(M * 100 + N)
    x = rng.normal(0, 2, (6, 257)).astype(np.float32)
    mask = rng.random((6, 257)) > 0.25
    mask[0] = False                          # an all-masked row
    v = quantize_stable_scores(torch.from_numpy(x), cfg, mask=torch.from_numpy(mask))
    assert np.array_equal(v.numpy(), np.asarray(j_quantize(jnp.asarray(x), jcfg,
                                                           mask=jnp.asarray(mask))))
    got, ap = dataflow.ap_softmax_batch(v.numpy(), cfg, mask=mask)
    want, jap = jdf.ap_softmax_batch(v.numpy(), jcfg, mask=mask)
    assert np.array_equal(got, want)
    assert ap.cycle_log == jap.cycle_log and ap.cycles == jap.cycles
    alg1 = int_softmax_from_codes(v, cfg, mask=torch.from_numpy(mask), assume_stable=True)
    assert np.array_equal(got, alg1.numpy())
    assert np.array_equal(got, np.asarray(j_from_codes(
        jnp.asarray(v.numpy()), jcfg, mask=jnp.asarray(mask), assume_stable=True)))


def test_dataflow_batched_single_pass():
    """A 1024-row batch runs as ONE vectorized pass (the per-vector entry
    point is stubbed out to prove it is never called), stays bit-exact
    against Alg. 1 and prices the sequential single-AP schedule."""
    cfg = PrecisionConfig(M=6, N=16)
    rng = np.random.default_rng(42)
    x = rng.normal(0, 2, (1024, 128)).astype(np.float32)
    mask = rng.random((1024, 128)) > 0.2
    v = quantize_stable_scores(torch.from_numpy(x), cfg, mask=torch.from_numpy(mask))
    _, ap_single = dataflow.ap_softmax_vector(v[0].numpy(), cfg, mask=mask[0])
    orig = dataflow.ap_softmax_vector

    def boom(*a, **k):
        raise AssertionError("ap_softmax_rows fell back to a per-row loop")

    dataflow.ap_softmax_vector = boom
    try:
        got, cycles = dataflow.ap_softmax_rows(v.numpy(), cfg, mask=mask)
    finally:
        dataflow.ap_softmax_vector = orig
    ref = int_softmax_from_codes(v, cfg, mask=torch.from_numpy(mask), assume_stable=True)
    assert np.array_equal(got, ref.numpy())
    assert cycles == 1024 * ap_single.cycles


def test_dataflow_cycles_match_breakdown():
    cfg = PrecisionConfig(M=6, N=16)
    x = np.random.default_rng(0).normal(0, 1, (1, 512)).astype(np.float32)
    v = quantize_stable_scores(torch.from_numpy(x), cfg).numpy()
    _, ap = dataflow.ap_softmax_vector(v[0], cfg)
    br = cm.softmax_cycle_breakdown(cfg, 512)
    for step, cyc in br.items():
        assert ap.cycle_log.get(step, 0) == cyc, step
    overhead = {"saturate", "mask_register"}
    assert ap.cycles == sum(br.values()) + sum(ap.cycle_log.get(s, 0) for s in overhead)


def test_incam_division_costs_more_but_same_values():
    cfg = PrecisionConfig(M=6, N=16)
    x = np.random.default_rng(3).normal(0, 1, (1, 128)).astype(np.float32)
    v = quantize_stable_scores(torch.from_numpy(x), cfg).numpy()
    out_a, ap_a = dataflow.ap_softmax_vector(v[0], cfg, incam_division=False)
    out_b, ap_b = dataflow.ap_softmax_vector(v[0], cfg, incam_division=True)
    assert np.array_equal(out_a, out_b)
    assert ap_b.cycles > ap_a.cycles


def test_area_anchors():
    """Paper Sec. V-B: 0.64 / 0.81 / 1.28 mm^2 for 7b/13b/70b."""
    for model, paper in [("llama2-7b", 0.64), ("llama2-13b", 0.81), ("llama2-70b", 1.28)]:
        area = pipeline.summarize(model)["area_mm2"]
        assert abs(area - paper) / paper < 0.05, (model, area, paper)


@pytest.mark.parametrize("model", list(pipeline.LLAMA_SPECS))
def test_pipeline_equals_reference(model):
    """``compare_point`` at a few cells, ``sweep`` and ``summarize``: every
    number equal to the reference's, exactly."""
    for seq, batch in ((128, 1), (1024, 8), (4096, 32)):
        assert pipeline.compare_point(model, seq, batch) == \
            jpipe.compare_point(model, seq, batch)
    assert pipeline.sweep(model) == jpipe.sweep(model)
    assert pipeline.summarize(model) == jpipe.summarize(model)
    cfg, jcfg = PrecisionConfig(M=8, N=12), JPC(M=8, N=12)
    assert pipeline.summarize(model, cfg) == jpipe.summarize(model, jcfg)


def test_pipeline_tables_and_gpu_model_equal_reference():
    assert pipeline.energy_per_op_pj() == jpipe.energy_per_op_pj()
    assert pipeline.energy_per_cell_cycle_pj() == jpipe.energy_per_cell_cycle_pj()
    assert pipeline.fig1_softmax_fraction() == jpipe.fig1_softmax_fraction()
    for g, jg in ((gpu_model.A100, jgm.A100), (gpu_model.RTX3090, jgm.RTX3090)):
        assert dataclasses.astuple(g) == dataclasses.astuple(jg)
        assert gpu_model.softmax_cost(g, 4, 32, 512, 512) == \
            jgm.softmax_cost(jg, 4, 32, 512, 512)
    assert cm.E_CELL_FJ == jcm.E_CELL_FJ


@pytest.mark.parametrize("masked", [False, True])
def test_ap_sim_backend_equals_int(masked):
    """``ap_sim`` (codes to the host, the AP program, back) equals plain
    torch Alg. 1 bitwise over any axis, is not differentiable or
    capturable, and meters as the reference's ap_sim."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal((2, 3, 5, 40)) * 3).astype(np.float32))
    mask = torch.from_numpy(rng.random((1, 3, 5, 40)) > 0.3) if masked else None
    b, alg1 = get_backend("ap_sim"), get_backend("int")
    for axis in (-1, 2):
        m = None if mask is None else mask.movedim(-1, axis) if axis != -1 else mask
        xs = x.movedim(-1, axis) if axis != -1 else x
        assert torch.equal(b.apply(xs, mask=m, axis=axis), alg1.apply(xs, mask=m, axis=axis))
    assert not b.differentiable and not b.capturable and alg1.capturable
    meta = b.apply(torch.empty((2, 4, 1, 64), device="meta"))
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    j = jget_backend("ap_sim")
    assert dataclasses.astuple(b.meter((2, 4, 1, 64), heads=4)) == \
        dataclasses.astuple(j.meter((2, 4, 1, 64), heads=4))
