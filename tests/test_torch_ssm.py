"""The SSD block of the port (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the same inputs, drawn from a numpy
seed, with the reference's parameters (mamba2-780m's smoke config: d 128,
8 heads of 16, state 16, chunk 32).

Tolerances, relative to each output's largest magnitude: in f32 the two
packages sum in other orders (cumsum, einsum contractions), 2e-5 (the
block outputs, after two GEMMs and a norm, 8e-5); in bf16 the chunk
products round to bf16 at each pairwise contraction, 2^-6 (the block
outputs 2^-4), and the f32 state 1e-2. The grid rule (a sequence longer than a chunk is a
whole number of chunks) fails in both packages on the same length.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jsmoke
from repro.models import ssm as jssm
from repro.models.layers import Ctx as JCtx
from repro.models.model import Model as JModel
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import layer_params

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2 ** -6, 1e-2)}
_BLOCKS = {}


def _block(name):
    """Layer 0's SSM parameters of the reference's smoke mamba2, in both
    packages (the port's through ``convert.params_from_numpy``)."""
    if name not in _BLOCKS:
        jdt, tdt = DTYPES[name][:2]
        jm = JModel(jsmoke("mamba2-780m"), dtype=jdt)
        jp = jax.jit(lambda k: jm.init_split(k)[0])(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tsmoke("mamba2-780m"), "cpu", tdt)
        _BLOCKS[name] = (jm.cfg, jax.tree.map(lambda a: a[0], jp["stack"]["layers"]["ssm"]),
                         layer_params(tp["stack"]["layers"]["ssm"], 0))
    return _BLOCKS[name]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(want, got, rel, what):
    want, got = _np(want), _np(got)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(want - got).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} x {scale}"


def _ssd_inputs(l, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, h, p, g, n = 2, 8, 16, 1, 16
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32)
    A = np.log(rng.uniform(1, 16, (h,))).astype(np.float32)
    B = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    jdt, tdt = DTYPES[dtype][:2]
    j = [jnp.asarray(x, jdt), jnp.asarray(dt, jdt), jnp.asarray(A), jnp.asarray(B, jdt),
         jnp.asarray(C, jdt)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt).to(tdt), torch.from_numpy(A),
         torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt)]
    return j, t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l", [24, 96])
def test_ssd_chunked_matches_reference(l, dtype):
    """One chunk shorter than the chunk size, and three chunks (the scan
    across chunks)."""
    j, t = _ssd_inputs(l, dtype)
    jy, jst = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(*j, chunk=32)
    ty, tst = tssm.ssd_chunked(*t, chunk=32)
    assert ty.dtype == DTYPES[dtype][1] and tst.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape and tuple(tst.shape) == jst.shape
    _close(jy, ty, DTYPES[dtype][2], "y")
    _close(jst, tst, DTYPES[dtype][3], "final state")


def test_grid_rule_fails_in_both_packages():
    j, t = _ssd_inputs(48, "f32")
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*j, chunk=32)
    with pytest.raises(ValueError, match="multiple of it"):
        tssm.ssd_chunked(*t, chunk=32)


def _x(b, l, d, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, (b, l, d)).astype(np.float32)
    jdt, tdt = DTYPES[dtype][:2]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_apply_with_state(dtype):
    cfg, jp, tp = _block(dtype)
    jdt, tdt, rel, srel = DTYPES[dtype]
    jx, tx = _x(2, 64, cfg.d_model, dtype)
    jy, jc = jax.jit(lambda p, x: jssm.ssm_apply(p, x, cfg, JCtx(dtype=jdt),
                                                 return_state=True))(jp, jx)
    ty, tc = tssm.ssm_apply(tp, tx, cfg, TCtx(dtype=tdt), return_state=True)
    _close(jy, ty, rel * 4, "out")
    _close(jc["state"], tc["state"], srel, "state")
    assert tc["conv"].dtype == tdt and tuple(tc["conv"].shape) == jc["conv"].shape
    _close(jc["conv"], tc["conv"], rel, "conv tail")     # pre-conv rows: the in_proj's


def _cache(cfg, dtype, seed=2):
    rng = np.random.default_rng(seed)
    st = rng.normal(0, 1, (2, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    cd = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = rng.normal(0, 1, (2, cfg.ssm_conv - 1, cd)).astype(np.float32)
    # separate buffers: the port writes its cache in place, and a jax array
    # on the CPU may share the numpy buffer it was made from
    return ({"state": jnp.asarray(st.copy()), "conv": jnp.asarray(conv, jnp.bfloat16)},
            {"state": torch.from_numpy(st.copy()),
             "conv": torch.from_numpy(conv.copy()).to(torch.bfloat16)})


def _conv_equal(want, got, dtype):
    """The conv tail (bf16 in both) holds the in_proj's rows: bitwise in a
    bf16 model; an f32 model's rows differ in their last bits between the
    two GEMMs, so one bf16 rounding apart (2^-7 relative)."""
    if dtype == "bf16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _close(want, got, 2 ** -7, "conv tail")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_decode(dtype):
    cfg, jp, tp = _block(dtype)
    jdt, tdt, rel, srel = DTYPES[dtype]
    jc, tc = _cache(cfg, dtype)
    jx, tx = _x(2, 1, cfg.d_model, dtype)
    jy, jnew = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, c, cfg, JCtx(dtype=jdt)))(
        jp, jx, jc)
    ty, tnew = tssm.ssm_decode(tp, tx, tc, cfg, TCtx(dtype=tdt))
    assert tnew is tc          # written in place
    _close(jy, ty, rel * 4, "out")
    _close(jnew["state"], tnew["state"], srel, "state")
    _conv_equal(jnew["conv"], tnew["conv"], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_verify_snapshots(dtype):
    """T = 4 tokens: the outputs and every per-token snapshot [T, B, ...]
    against the reference's scan; the cache ends at the last token."""
    cfg, jp, tp = _block(dtype)
    jdt, tdt, rel, srel = DTYPES[dtype]
    jc, tc = _cache(cfg, dtype)
    jx, tx = _x(2, 4, cfg.d_model, dtype)
    jy, jsnap = jax.jit(lambda p, x, c: jssm.ssm_verify(p, x, c, cfg, JCtx(dtype=jdt)))(
        jp, jx, jc)
    ty, tsnap = tssm.ssm_verify(tp, tx, tc, cfg, TCtx(dtype=tdt))
    assert tsnap["state"].shape == jsnap["state"].shape
    assert tsnap["conv"].shape == jsnap["conv"].shape
    _close(jy, ty, rel * 4, "out")
    _close(jsnap["state"], tsnap["state"], srel, "state snapshots")
    _conv_equal(jsnap["conv"], tsnap["conv"], dtype)
    assert torch.equal(tc["state"], tsnap["state"][-1])
    assert torch.equal(tc["conv"], tsnap["conv"][-1])
