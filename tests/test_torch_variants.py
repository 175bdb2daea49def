"""The softmax-variant zoo of the port (``core/softmax_variants.py``,
``backends/variant_backends.py``, the learnable ``smx`` parameters) against
the reference on the same numpy-seeded inputs.

* Bitwise: ``quantize_raw_scores`` and the ``affine_*`` grid; ConSmax's
  integer exp codes (``consmax_codes``: Alg. 1's quantizer and integer exp);
  every variant's CostReport and design (the port's ``ap/cost_model.py`` is
  a copy of the reference's).
* Within a stated bound: the variants' probabilities across frameworks
  (tier (b) of ROADMAP.md). The forward values are integer codes times
  constants (ConSmax: ``g * (y_fp + (y_int - y_fp))``, y_int exact), or
  multiples of ``2^-w_vapprox`` summed exactly (SOLE, MIVE); what may differ
  is XLA's and torch's ``exp`` / ``exp2`` / ``log2`` at an ulp, which moves
  a probability (at most 1 here, gamma up to 2) by a few f32 ulps:
  ``PROB_TOL`` = 2^-20 absolute.
* Gradients of ConSmax (its straight-through backward) with respect to the
  scores, beta and gamma: torch autograd against ``jax.grad`` within
  ``GRAD_RTOL`` = 1e-5 of the largest gradient (f32 sums in another order).
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.backends import get_backend as jget_backend
from repro.configs.registry import smoke_config as jsmoke
from repro.core import quantization as jq
from repro.core import softmax_variants as jsv
from repro.core.alg1 import int_exp_codes as j_int_exp_codes
from repro.core.precision import PrecisionConfig as JPC
from repro.models.model import Model as JModel
from repro_torch.backends import get_backend
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as tq
from repro_torch.core import softmax_variants as tsv
from repro_torch.core.precision import PrecisionConfig as TPC
from repro_torch.models.model import Model

torch.set_num_threads(2)

PROB_TOL = 2.0 ** -20
GRAD_RTOL = 1e-5
POINTS = {"BEST": (JPC(), TPC()), "M6N16": (JPC(M=6, N=16), TPC(M=6, N=16)),
          "M8N12": (JPC(M=8, N=12), TPC(M=8, N=12))}


def _scores(seed, shape=(3, 4, 5, 67), scale=3.0):
    """Scores with masked entries, one all-masked row and one lone valid
    entry, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    mask = rng.random(shape) > 0.3
    mask[0, 0, 0] = False                 # an all-masked row
    mask[0, 0, 1] = False
    mask[0, 0, 1, 3] = True               # a lone valid entry
    return x, mask


def _cfgs(kind, point):
    jc, tc = POINTS[point]
    if kind == "consmax":
        return jsv.ConSmaxCfg(precision=jc), tsv.ConSmaxCfg(precision=tc)
    return jc, tc


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("kind", ["consmax", "sole_softmax", "mive_softmax"])
def test_variant_matches_reference(kind, point, masked):
    x, mask = _scores(zlib.crc32(f"{kind} {point}".encode()))
    jc, tc = _cfgs(kind.split("_")[0], point)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = np.asarray(getattr(jsv, kind)(jnp.asarray(x), jc, mask=jm))
    got = getattr(tsv, kind)(torch.from_numpy(x), tc, mask=tm).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    if masked:
        assert not got[~mask].any()
        if kind != "consmax":             # a normalized variant: zero rows stay zero
            assert not got[0, 0, 0].any()


@pytest.mark.parametrize("point", list(POINTS))
def test_consmax_codes_bitwise(point):
    """ConSmax's integer exp codes: the reference's expression (round of the
    clipped scores less beta over S, then ``alg1.int_exp_codes``) bitwise,
    with per-head beta broadcast as attention passes it."""
    jc, tc = _cfgs("consmax", point)
    x, _ = _scores(7, scale=6.0)
    beta = np.random.default_rng(8).uniform(-2, 1, (4, 1, 1)).astype(np.float32)
    pc = jc.precision
    xs = jnp.clip(jnp.asarray(x) - jnp.asarray(beta), pc.T_C, 0.0)
    v = jnp.round(xs / jnp.float32(pc.S)).astype(jnp.int32)
    want = np.asarray(j_int_exp_codes(v, pc))
    got = tsv.consmax_codes(torch.from_numpy(x), tc, torch.from_numpy(beta)).numpy()
    np.testing.assert_array_equal(got, want)


def test_consmax_learned_params_match_reference():
    """Per-head beta/gamma tensors (the learned ``smx`` values) broadcast
    over [B, KV, G, Sq, Skv] scores as the reference's."""
    x, mask = _scores(11, shape=(2, 2, 3, 4, 33))
    rng = np.random.default_rng(12)
    beta = rng.uniform(-1, 1, (2, 3, 1, 1)).astype(np.float32)
    gamma = rng.uniform(0.5, 2, (2, 3, 1, 1)).astype(np.float32)
    want = np.asarray(jsv.consmax(jnp.asarray(x), mask=jnp.asarray(mask),
                                  beta=jnp.asarray(beta), gamma=jnp.asarray(gamma)))
    got = tsv.consmax(torch.from_numpy(x), mask=torch.from_numpy(mask),
                      beta=torch.from_numpy(beta), gamma=torch.from_numpy(gamma)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * PROB_TOL)


def test_consmax_gradients_match_jax():
    """ConSmax's straight-through backward: d/d(scores, beta, gamma) of a
    weighted sum, torch autograd against jax.grad."""
    x, mask = _scores(21, shape=(2, 4, 3, 16))
    rng = np.random.default_rng(22)
    beta = rng.standard_normal((4, 1, 1)).astype(np.float32)
    gamma = (1 + rng.random((4, 1, 1))).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(x, b, g):
        return (jsv.consmax(x, mask=jnp.asarray(mask), beta=b, gamma=g) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(beta),
                                             jnp.asarray(gamma))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, beta, gamma)]
    y = tsv.consmax(leaves[0], mask=torch.from_numpy(mask), beta=leaves[1], gamma=leaves[2])
    (y * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, want):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(j).max()))


@pytest.mark.parametrize("point", list(POINTS))
def test_quantize_raw_scores_bitwise(point):
    jc, tc = POINTS[point]
    x = (np.random.default_rng(3).standard_normal((5, 129)) * 5).astype(np.float32)
    for calib in (0.0, 2.5, 7.25):
        want = np.asarray(jq.quantize_raw_scores(jnp.asarray(x), jc, calib))
        got = tq.quantize_raw_scores(torch.from_numpy(x), tc, calib).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,symmetric", [(8, False), (8, True), (4, False), (16, True)])
def test_affine_grid_bitwise(bits, symmetric):
    x = (np.random.default_rng(bits).standard_normal((7, 33)) * 3).astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    assert tq.affine_qparams(lo, hi, bits, symmetric) == jq.affine_qparams(lo, hi, bits,
                                                                          symmetric)
    scale, zero = tq.affine_qparams(lo, hi, bits, symmetric)
    want = np.asarray(jq.affine_quantize(jnp.asarray(x), scale, zero, bits))
    got = tq.affine_quantize(torch.from_numpy(x), scale, zero, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tq.affine_dequantize(got, scale, zero).numpy(),
        np.asarray(jq.affine_dequantize(jnp.asarray(want), scale, zero)))


@pytest.mark.parametrize("kind", ["consmax", "sole", "mive"])
def test_variant_backend_meters_equal_reference(kind):
    """The variants' CostReports and AP designs equal the reference's, at
    the default and at another precision point, for decode and prefill
    shapes."""
    for jc, tc in (POINTS["BEST"], POINTS["M8N12"]):
        jb, tb = jget_backend(kind, jc), get_backend(kind, tc)
        assert (tb.name, tb.metered, tb.differentiable) == (jb.name, jb.metered,
                                                            jb.differentiable)
        assert getattr(tb, "learnable", False) == getattr(jb, "learnable", False)
        for shape, heads in (((2, 4, 1, 1, 96), 4), ((1, 8, 2, 64, 64), 16)):
            assert dataclasses.astuple(tb.meter(shape, heads=heads)) == \
                dataclasses.astuple(jb.meter(shape, heads=heads))
        assert dataclasses.astuple(tb.design(4096)) == dataclasses.astuple(jb.design(4096))


def test_variant_cycles_ordered_below_alg1():
    """The zoo's point: mive < sole < consmax < the full Alg.-1 softmax."""
    cyc = {k: get_backend(k).meter((1, 64)).cycles for k in ("mive", "sole", "consmax", "int")}
    assert cyc["mive"] < cyc["sole"] < cyc["consmax"] < cyc["int"]


def test_model_init_carries_smx():
    """A GQA model built with ``consmax`` carries per-head beta/gamma [L, H]
    f32 at the backend's operating point; MLA and non-learnable kinds carry
    none, as the reference."""
    cfg = tsmoke("olmo-1b", softmax=tsv.SoftmaxSpec("consmax"))
    p = Model(cfg, device="cpu").init()
    smx = p["stack"]["layers"]["attn"]["smx"]
    for name, val in (("beta", 0.0), ("gamma", 1.0)):
        assert smx[name].dtype == torch.float32
        assert tuple(smx[name].shape) == (cfg.n_layers, cfg.n_heads)
        assert bool((smx[name] == val).all())
    for arch, kind in (("minicpm3-4b", "consmax"), ("olmo-1b", "sole")):
        q = Model(tsmoke(arch, softmax=tsv.SoftmaxSpec(kind)), device="cpu").init()
        assert "smx" not in q["stack"]["layers"]["attn"]


def test_converter_carries_reference_smx():
    """The reference's ``Model.init`` with ConSmax, its ``smx`` leaves set to
    non-default values, converts: beta/gamma as f32, and the port's logits
    with them follow the reference's (f32 smoke model; the forward's
    products and exp differ at an ulp, so within 1e-4)."""
    jcfg = jsmoke("olmo-1b", softmax=jsv.SoftmaxSpec("consmax"))
    tcfg = tsmoke("olmo-1b", softmax=tsv.SoftmaxSpec("consmax"))
    jm = JModel(jcfg, dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jm.init_split(jax.random.PRNGKey(0))[0])
    smx = jp["stack"]["layers"]["attn"]["smx"]
    rng = np.random.default_rng(5)
    smx["beta"] = rng.uniform(-1, 0.5, smx["beta"].shape).astype(np.float32)
    smx["gamma"] = rng.uniform(0.5, 1.5, smx["gamma"].shape).astype(np.float32)
    tp = params_from_numpy(jp, tcfg, "cpu", torch.float32)
    for name in ("beta", "gamma"):
        got = tp["stack"]["layers"]["attn"]["smx"][name]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), smx[name])
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 11)).astype(np.int32)
    want, _ = jm.train_logits(jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(tokens)})
    got, _ = Model(tcfg, dtype=torch.float32, device="cpu").train_logits(
        tp, {"tokens": torch.as_tensor(tokens, dtype=torch.long)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
