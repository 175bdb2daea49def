"""The port's softmax backend registry and AP cost meter against the
reference's: the same kind strings resolve, ``apply`` agrees (bitwise for
the integer kinds), and ``meter()`` returns equal CostReports — including
the golden Table-II pins of ``tests/test_cost_golden.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.backends import available_backends as javailable_backends
from repro.backends import get_backend as jget_backend
from repro.core import precision as jprec
from repro_torch.ap import cost_model as tcm
from repro_torch.backends import available_backends, get_backend
from repro_torch.core import precision as tprec
from repro_torch.core.softmax_variants import SoftmaxSpec, get_softmax

torch.set_num_threads(2)

PORTED = ["fp", "fp_lowp", "clipped_fp", "int", "int_jax", "int_ste", "int_pallas",
          "int_pallas_paged", "ap_sim", "consmax", "sole", "mive"]
INT_KINDS = ["int", "int_jax", "int_ste", "int_pallas", "int_pallas_paged", "ap_sim"]
VARIANT_KINDS = ["consmax", "sole", "mive"]


def test_ported_kinds_registered():
    """Every kind of the reference's registry is ported (the variant zoo
    and ap_sim since ROADMAP item 12), and no other."""
    assert set(available_backends()) == set(PORTED) == set(javailable_backends())
    with pytest.raises(ValueError, match="unknown softmax kind"):
        SoftmaxSpec("nope")


@pytest.mark.parametrize("kind", PORTED)
def test_kind_resolves_with_reference_name(kind):
    b = SoftmaxSpec(kind).backend()
    ref = jget_backend(kind)
    assert b.name == ref.name
    assert b.metered == ref.metered
    assert b.differentiable == ref.differentiable
    # aliases share one instance, like the reference registry
    if kind in ("int", "int_jax"):
        assert get_backend("int") is get_backend("int_jax", tprec.BEST)


@pytest.mark.parametrize("kind", PORTED)
def test_apply_matches_reference(kind):
    """Integer kinds bitwise; fp kinds within 1e-6 (exp/sum ulps)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 4, 33)) * 3).astype(np.float32)
    m = rng.random((2, 1, 1, 33)) < 0.8
    ref = np.asarray(jget_backend(kind).apply(jnp.asarray(x), mask=jnp.asarray(m)))
    got = get_softmax(SoftmaxSpec(kind))(torch.from_numpy(x),
                                         mask=torch.from_numpy(m)).numpy()
    if kind in INT_KINDS:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


SHAPES = [((2, 4, 1, 64), 4), ((4, 16, 1, 1, 544), 16), ((4, 16, 1, 512, 512), 16),
          ((3, 2, 2, 8, 8), 4), ((1, 1, 1, 1, 1), 1), ((0, 4, 1, 8), 4)]


@pytest.mark.parametrize("kind", INT_KINDS + VARIANT_KINDS + ["fp"])
@pytest.mark.parametrize("cfg_kw", [dict(M=6, N=16), dict(M=4, T_C=-4.0),
                                    dict(M=8, N=12, v_corr_extra=2)])
def test_meter_equals_reference(kind, cfg_kw):
    ours = get_backend(kind, tprec.PrecisionConfig(**cfg_kw))
    ref = jget_backend(kind, jprec.PrecisionConfig(**cfg_kw))
    for shape, heads in SHAPES:
        a, b = ours.meter(shape, heads=heads), ref.meter(shape, heads=heads)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b), shape


# ---- the golden pins of tests/test_cost_golden.py, on the port's copy


def test_table2_elementary_op_cycles():
    assert {m: tcm.cycles_add(m) for m in (4, 6, 8)} == {4: 45, 6: 67, 8: 89}
    assert {m: tcm.cycles_mult(m) for m in (4, 6, 8)} == {4: 144, 6: 312, 8: 544}
    assert tcm.cycles_reduction(6, 64) == 101
    assert tcm.cycles_reduction(6, 1024) == 133


def test_hardware_constants_pinned():
    assert (tcm.E_CELL_FJ, tcm.CELL_AREA_UM2, tcm.FREQ_HZ) == (0.85, 0.121, 1.0e9)
    assert tcm.row_bits_for(tprec.BEST) == 81
    assert tprec.BEST == tprec.PrecisionConfig(M=6, N=16)


def test_softmax_cycle_breakdown_golden():
    assert sum(tcm.softmax_cycle_breakdown(tprec.BEST, 64).values()) == 1893
    assert sum(tcm.softmax_cycle_breakdown(
        tprec.PrecisionConfig(M=8, N=16), 1024).values()) == 2777
    assert tcm.cycles_division_incam(
        tprec.BEST.P_out, tprec.BEST.table1_widths()["sum"]) == 5424


def test_softmax_vector_cost_and_meter_golden():
    cycles, latency, energy, design = tcm.softmax_vector_cost(tprec.BEST, 64)
    assert cycles == 1893
    assert latency == pytest.approx(1.893e-06)
    assert energy == pytest.approx(4.1706576e-09)
    assert (design.rows, design.row_bits) == (32, 81)
    rep = get_backend("int", tprec.BEST).meter((2, 4, 1, 64), heads=4)
    assert (rep.vectors, rep.cycles) == (8, 2 * 1893)
    assert rep.latency_s == pytest.approx(2 * 1.893e-06)
    assert rep.energy_j == pytest.approx(8 * 4.1706576e-09)


def test_fp_backend_unmetered():
    assert get_backend("fp").meter((2, 4, 1, 64)) is None
