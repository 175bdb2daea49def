"""K1 wrapper (``repro_torch.kernels.int_softmax.ops``) against the
reference's Pallas kernel, bitwise.

On CPU tensors the wrapper runs its plain version; it must equal
``int_softmax_pallas`` (interpret mode off-TPU, as the reference's own tests
run it) bit for bit, with and without masks, over leading dims with the
attention mask's broadcast. The CUDA kernel itself runs only on the card
(the ``cuda`` cases skip here; ``chip_smoke.py`` holds it against its plain
version at the main path's shapes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import precision as jprec
from repro.kernels.int_softmax.ops import int_softmax_pallas
from repro_torch.core import precision as tprec
from repro_torch.kernels.int_softmax import ops
from repro_torch.kernels.int_softmax.ref import int_softmax_ref

torch.set_num_threads(2)

# m15: above the CUDA kernel's exp table (M <= 14), so it computes each exp
CFG_KW = {"best": dict(M=6, N=16, T_C=-7.0), "m4": dict(M=4, T_C=-4.0),
          "m15": dict(M=15, T_C=-1.0, P_out_override=24)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    # causal-style mask broadcast like attend's mask[:, None, None]: row 0 of
    # each [Sq, Skv] block has one valid element (the lone-element case)
    b, sq, skv = shape[0], shape[-2], shape[-1]
    m = np.tril(np.ones((sq, skv), bool), k=skv - sq)
    m = np.broadcast_to(m, (b, 1, 1, sq, skv)).copy()
    m[-1, ..., -1, :] = False       # one fully masked row
    return x, m


@pytest.mark.parametrize("name", CFG_KW)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 3, 5, 5), (1, 1, 2, 3, 37)])
def test_wrapper_cpu_matches_pallas(name, masked, shape):
    jc, tc = (jprec.PrecisionConfig(**CFG_KW[name]),
              tprec.PrecisionConfig(**CFG_KW[name]))
    x, m = _inputs(shape)
    if not masked:
        m = None
    ref = int_softmax_pallas(jnp.asarray(x), jc,
                             mask=None if m is None else jnp.asarray(m))
    got = ops.int_softmax_cuda(torch.from_numpy(x), tc,
                               mask=None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_cpu_does_not_launch():
    before = ops.int_softmax_rows.launches
    ops.int_softmax_cuda(torch.zeros(3, 4), tprec.BEST)
    assert ops.int_softmax_rows.launches == before


def test_wrapper_rejects_other_axis():
    with pytest.raises(ValueError, match="last axis"):
        ops.int_softmax_cuda(torch.zeros(3, 4), tprec.BEST, axis=0)


def test_alg1_consts_mirror_precision():
    c = ops.alg1_consts(tprec.BEST)
    assert (c.M, c.P_out, c.v_ln2, c.mu, c.v_b, c.v_c) == (
        6, 24, tprec.BEST.v_ln2, tprec.BEST.mu, tprec.BEST.v_b, tprec.BEST.v_c)
    assert c.sum_sat == tprec.BEST.sum_saturation
    assert c.S == tprec.BEST.S and c.T_C == tprec.BEST.T_C


@pytest.mark.cuda
@pytest.mark.parametrize("name", CFG_KW)
@pytest.mark.parametrize("rows,cols", [(64, 544), (37, 1), (8, 1000), (4, 32768),
                                       (64, 543), (3, 40001), (2, 131072)])
def test_kernel_matches_plain_on_card(name, rows, cols):
    """The CUDA kernel equals its plain version bit for bit on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cfg = tprec.PrecisionConfig(**CFG_KW[name])
    rng = np.random.default_rng(rows + cols)
    x = torch.from_numpy((rng.standard_normal((rows, cols)) * 3)
                         .astype(np.float32)).cuda()
    m = torch.from_numpy(rng.random((rows, cols)) < 0.7).cuda()
    m[0] = False
    for mask in (None, m):
        got = ops.int_softmax_cuda(x, cfg, mask=mask)
        want = int_softmax_ref(x, cfg, mask)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
