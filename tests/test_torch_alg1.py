"""The port's Alg. 1 (``repro_torch.core``) against the reference's, bitwise.

Same f32 scores in, made with numpy from a seed; every integer code and
every probability must be equal bit for bit (parity tier (a) of ROADMAP.md),
at BEST, at the paper's M=4 point (T_C=-4) and at M=8.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import alg1 as jalg1
from repro.core import precision as jprec
from repro.core import quantization as jquant
from repro_torch.core import alg1 as talg1
from repro_torch.core import int_softmax as tint
from repro_torch.core import precision as tprec
from repro_torch.core import quantization as tquant

# repro.core re-exports a function named int_softmax over the submodule
jint = importlib.import_module("repro.core.int_softmax")

torch.set_num_threads(2)

CFG_KW = {"best": dict(M=6, N=16, T_C=-7.0),
          "m4": dict(M=4, T_C=-4.0),
          "m8": dict(M=8, N=16)}
LENGTHS = [1, 7, 257]


def cfgs(name):
    kw = CFG_KW[name]
    return jprec.PrecisionConfig(**kw), tprec.PrecisionConfig(**kw)


def scores(rows, cols, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((rows, cols))
            * scale).astype(np.float32)


def row_mask(rows, cols, seed=1):
    """Random valid positions; row 0 fully masked, row 1 one valid element
    (the lone-element case), the rest about 70% valid."""
    m = np.random.default_rng(seed).random((rows, cols)) < 0.7
    m[0] = False
    if rows > 1:
        m[1] = False
        m[1, cols // 2] = True
    return m


def assert_bitwise(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CFG_KW)
@pytest.mark.parametrize("masked", [False, True])
def test_quantize_stable_scores(name, masked):
    jc, tc = cfgs(name)
    x = scores(9, 33)
    m = row_mask(9, 33) if masked else None
    ref = jquant.quantize_stable_scores(
        jnp.asarray(x), jc, mask=None if m is None else jnp.asarray(m))
    got = tquant.quantize_stable_scores(
        torch.from_numpy(x), tc, mask=None if m is None else torch.from_numpy(m))
    assert_bitwise(ref, got)


@pytest.mark.parametrize("name", CFG_KW)
def test_int_exp_codes_exhaustive(name):
    jc, tc = cfgs(name)
    v = np.arange(-(2 ** (tc.M - 1)), 1, dtype=np.int32)
    assert_bitwise(jalg1.int_exp_codes(jnp.asarray(v), jc),
                   talg1.int_exp_codes(torch.from_numpy(v), tc))


@pytest.mark.parametrize("saturation", [2 ** 30 - 1, 5000, 1])
def test_saturating_sum(saturation):
    x = np.random.default_rng(2).integers(0, 4096, (6, 37)).astype(np.int32)
    assert_bitwise(jalg1.saturating_sum(jnp.asarray(x), saturation),
                   talg1.saturating_sum(torch.from_numpy(x), saturation))
    with pytest.raises(ValueError):
        talg1.saturating_sum(torch.from_numpy(x), 2 ** 30)


@pytest.mark.parametrize("frac_bits", [16, 20, 24, 28])
def test_fixedpoint_div(frac_bits):
    rng = np.random.default_rng(3)
    den = rng.integers(1, 2 ** 30, 500).astype(np.int32)
    num = (rng.random(500) * den).astype(np.int32)
    num[:50] = den[:50]            # num == den: restoring division gives 2^P-1
    num[50:60] = 0
    assert_bitwise(jalg1.fixedpoint_div(jnp.asarray(num), jnp.asarray(den), frac_bits),
                   talg1.fixedpoint_div(torch.from_numpy(num), torch.from_numpy(den),
                                        frac_bits))


@pytest.mark.parametrize("name", CFG_KW)
@pytest.mark.parametrize("cols", LENGTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_int_softmax(name, cols, masked):
    jc, tc = cfgs(name)
    x = scores(8, cols, seed=cols)
    m = row_mask(8, cols) if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    ref = jax.jit(jint.int_softmax, static_argnums=1)(jnp.asarray(x), jc, mask=jm)
    assert_bitwise(ref, tint.int_softmax(torch.from_numpy(x), tc, mask=tm))
    ref = jax.jit(jalg1.int_softmax_block, static_argnums=2)(jnp.asarray(x), jm, jc)
    assert_bitwise(ref, talg1.int_softmax_block(torch.from_numpy(x), tm, tc))


@pytest.mark.parametrize("name", CFG_KW)
@pytest.mark.parametrize("div", ["auto", "bitserial"])
def test_lone_element_division_contract(name, div):
    """A row with one unmasked element has v_approx == total. Bitserial
    yields 2^P - 1; auto's fast path (only where w_vapprox + P_out <= 31,
    i.e. the M=4 point here) yields 2^P. Both packages agree."""
    jc, tc = cfgs(name)
    x = scores(3, 5)
    m = np.zeros((3, 5), bool)
    m[:, 2] = True
    v = np.asarray(jquant.quantize_stable_scores(jnp.asarray(x), jc,
                                                 mask=jnp.asarray(m)))
    ref = jalg1.int_softmax_from_codes(jnp.asarray(v), jc, mask=jnp.asarray(m),
                                       assume_stable=True, div=div)
    got = talg1.int_softmax_from_codes(torch.from_numpy(v), tc,
                                       mask=torch.from_numpy(m),
                                       assume_stable=True, div=div)
    assert_bitwise(ref, got)
    fast = div == "auto" and tc.w_vapprox + tc.P_out <= 31
    assert fast == (name == "m4" and div == "auto")
    want = 2 ** tc.P_out if fast else 2 ** tc.P_out - 1
    assert (got.numpy()[:, 2] == want).all()
    assert (got.numpy()[:, [0, 1, 3, 4]] == 0).all()


@pytest.mark.parametrize("name", CFG_KW)
def test_int_softmax_from_codes_raw(name):
    """assume_stable=False: the integer max-subtract and clip do real work
    on calibrated (offset) codes."""
    jc, tc = cfgs(name)
    v = np.random.default_rng(4).integers(-40, 40, (5, 19)).astype(np.int32)
    assert_bitwise(jalg1.int_softmax_from_codes(jnp.asarray(v), jc),
                   talg1.int_softmax_from_codes(torch.from_numpy(v), tc))


def test_int_softmax_ste_forward_and_backward():
    """STE: integer forward, fp-softmax gradient."""
    x = scores(4, 16)
    m = row_mask(4, 16, seed=5)
    m[0, 0] = True
    g = np.random.default_rng(6).standard_normal((4, 16)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    y = tint.int_softmax_ste(t, tprec.BEST, mask=torch.from_numpy(m))
    assert torch.equal(y, tint.int_softmax(torch.from_numpy(x), tprec.BEST,
                                           mask=torch.from_numpy(m)))
    (gx,) = torch.autograd.grad(y, t, torch.from_numpy(g))
    t2 = torch.from_numpy(x).requires_grad_(True)
    (gfp,) = torch.autograd.grad(
        tint.fp_softmax(t2, mask=torch.from_numpy(m)), t2, torch.from_numpy(g))
    assert torch.equal(gx, gfp)


@pytest.mark.parametrize("fn", ["fp_softmax", "fp_softmax_lowp", "clipped_fp_softmax"])
def test_fp_baselines(fn):
    """fp family: exp and the sum differ in the last ulps between XLA and
    torch, so within 1e-6 absolute (probabilities are <= 1)."""
    x = scores(6, 40)
    m = row_mask(6, 40, seed=7)
    kw = {"t_c": -7.0} if fn == "clipped_fp_softmax" else {}
    ref = getattr(jint, fn)(jnp.asarray(x), mask=jnp.asarray(m), **kw)
    got = getattr(tint, fn)(torch.from_numpy(x), mask=torch.from_numpy(m), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
