"""K3, the fused prefill attention (a stand-alone op), against the
reference: the port's plain version (what the CPU wrapper runs) against the
reference's Pallas kernel in interpret mode (``int_attention_pallas``, as
the reference's own tests run it) and its oracle (``int_attention_ref``),
on the matrix of ``tests/test_kernels.py:61-101``: causal on and off, a
window, GQA, bf16 inputs. Tolerances are the reference's: 5e-3 in f32 (a
product summed in another order can move a score across a rounding
boundary of the M-bit grid); for bf16 inputs 2e-2 against the oracle on
f32-upcast inputs. Also the wrapper's shape errors, and a ``cuda`` case
that holds the CUDA kernel against its plain version (the kernel's tiled
passes are checked on the CPU in ``test_torch_int_attention_split.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.precision import BEST as JBEST
from repro.kernels.int_attention.ops import int_attention_pallas
from repro.kernels.int_attention.ref import int_attention_ref as jref
from repro_torch.core.precision import BEST
from repro_torch.kernels.int_attention import ops
from repro_torch.kernels.int_attention.ref import int_attention_ref

torch.set_num_threads(2)

ATOL = 5e-3


def _inputs(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape_q).astype(dtype), rng.normal(0, 1, shape_kv).astype(dtype),
            rng.normal(0, 1, shape_kv).astype(dtype))


def _port(q, k, v, **kw):
    return ops.int_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             BEST, **kw).numpy()


@pytest.mark.parametrize("b,h,kv,sq,skv,d", [
    (2, 4, 2, 64, 64, 32), (1, 8, 8, 96, 96, 64), (2, 4, 1, 33, 33, 32),
    (1, 2, 2, 16, 64, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_and_oracle(b, h, kv, sq, skv, d, causal):
    q, k, v = _inputs((b, h, sq, d), (b, kv, skv, d), seed=b * 1000 + h * 10 + sq + causal)
    got = _port(q, k, v, causal=causal)
    assert got.dtype == np.float32 and got.shape == (b, h, sq, d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = np.asarray(int_attention_pallas(jq, jk, jv, JBEST, causal=causal, blk_q=16))
    oracle = np.asarray(jref(jq, jk, jv, JBEST, causal=causal))
    assert float(np.abs(got - kern).max()) < ATOL
    assert float(np.abs(got - oracle).max()) < ATOL


@pytest.mark.parametrize("window", [16, 5])
def test_plain_window_matches_reference(window):
    q, k, v = _inputs((1, 4, 64, 32), (1, 2, 64, 32), seed=window)
    got = _port(q, k, v, causal=True, window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = np.asarray(int_attention_pallas(jq, jk, jv, JBEST, causal=True, window=window,
                                           blk_q=16))
    oracle = np.asarray(jref(jq, jk, jv, JBEST, causal=True, window=window))
    assert float(np.abs(got - kern).max()) < ATOL
    assert float(np.abs(got - oracle).max()) < ATOL


def test_plain_bf16_inputs_match_reference():
    q, k, v = _inputs((1, 4, 32, 32), (1, 4, 32, 32), seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.int_attention(tq, tk, tv, BEST).numpy()
    up = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v)]
    oracle = np.asarray(jref(*(jnp.asarray(x) for x in up), JBEST))
    assert float(np.abs(got - oracle).max()) < 2e-2     # bf16 score noise
    kern = np.asarray(int_attention_pallas(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                           JBEST, blk_q=16))
    assert float(np.abs(got - kern).max()) < 2e-2


def test_scores_are_not_rounded_to_the_input_dtype():
    """The kernel's scores are the f32 dot of bf16 inputs, unrounded (the
    reference's oracle rounds them to bf16; its kernel does not)."""
    q, k, v = _inputs((1, 2, 8, 16), (1, 2, 8, 16), seed=4)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    _, scores, probs = int_attention_ref(tq, tk, tv, BEST, return_rows=True)
    exact = torch.einsum("bhqd,bhsd->bhqs", tq.double(), tk.double()).reshape(2, 8, 8)
    # within the f32 summation bound of 16 products (~1e-6 here)
    np.testing.assert_allclose(scores.numpy(), (exact.float() * 16 ** -0.5).numpy(),
                               rtol=0, atol=1e-6)
    assert not torch.equal(scores, exact.to(torch.bfloat16).float() * 16 ** -0.5)
    assert probs.shape == (2, 8, 8) and bool(torch.all(torch.triu(probs[0], 1) == 0))


def test_rows_wrapper_on_cpu_is_the_plain_version_and_does_not_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs((8, 12, 16), (2, 20, 16), seed=5))
    before = ops.int_attention_rows.launches
    sc = torch.zeros((8, 12, 20))
    pr = torch.zeros_like(sc)
    out = ops.int_attention_rows(q, k, v, BEST, causal=True, window=6, scores_out=sc,
                                 probs_out=pr)
    want, wsc, wpr = int_attention_ref(q[None], k[None], v[None], BEST, True, 6,
                                       return_rows=True)
    assert ops.int_attention_rows.launches == before
    assert torch.equal(out, want[0]) and torch.equal(sc, wsc) and torch.equal(pr, wpr)
    # right-aligned: query 0 sits at key position 8 and sees keys 3..8
    assert bool((pr[:, 0, :3] == 0).all() and (pr[:, 0, 9:] == 0).all())
    assert bool((pr[:, 0, 3:9] > 0).any())


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros((1, 3, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.int_attention(q, kv, kv)
    with pytest.raises(ValueError, match="shapes do not match"):
        ops.int_attention_rows(torch.zeros((4, 8, 16)), torch.zeros((2, 8, 16)),
                               torch.zeros((2, 8, 32)), BEST)
    with pytest.raises(ValueError, match="shapes do not match"):
        ops.int_attention_rows(torch.zeros((3, 8, 16)), torch.zeros((2, 8, 16)),
                               torch.zeros((2, 8, 16)), BEST)


# A tensor-core step of 16 products (mma.sync / wgmma, f32 accumulate) is
# bounded as fused sums that keep 24 bits of their largest addend and
# truncate: MMA_UNIT of (|partial before| + sum |products|) a step
# (chip_smoke.py:MMA_UNIT).
MMA_UNIT = 32 * 2.0 ** -23 * (1 + 2.0 ** -8)


def _mma_steps_bound(terms):
    """terms [..., n, X] (f64) summed over n, 16 a step from the first ->
    the bound of the tensor cores' f32 sum, [..., X]."""
    pad = (-terms.shape[-2]) % 16
    steps = torch.nn.functional.pad(terms, (0, 0, 0, pad)).unflatten(-2, (-1, 16))
    step, mass = steps.sum(-2), steps.abs().sum(-2)
    before = torch.cumsum(step, -2) - step
    return MMA_UNIT * (before.abs() + mass).sum(-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,kvh", [(True, 0, 2), (False, 0, 4), (True, 16, 1)])
def test_kernel_matches_plain_on_card(dtype, causal, window, kvh):
    """The CUDA kernel against its plain version: the plain Alg. 1 on the
    kernel's own scores gives its probabilities bitwise; scores within the
    kernel's summation bound plus the plain version's (d 2^-24 sum |q_i k_i|
    for an f32 sum; bf16 on tensor cores: MMA_UNIT a 16-deep step) and two
    roundings; outputs within both sides' summation bounds (f32: n 2^-24 sum
    |p| |v| over the n valid keys; bf16: MMA_UNIT a 16-key step in key
    order) plus sum_j |p_j - p'_j| |v_j|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.core.alg1 import int_softmax_block
    from repro_torch.kernels.int_attention.ref import attention_mask

    h, sq, skv, d = 4, 40, 72, 64
    q, k, v = (torch.from_numpy(x).to(dtype).cuda() for x in
               _inputs((h, sq, d), (kvh, skv, d), seed=kvh + window))
    sc = torch.zeros((h, sq, skv), device="cuda")
    pr = torch.zeros_like(sc)
    out = ops.int_attention_rows(q, k, v, BEST, causal=causal, window=window, scores_out=sc,
                                 probs_out=pr)
    want, wsc, wpr = int_attention_ref(q[None], k[None], v[None], BEST, causal, window,
                                       return_rows=True)
    torch.cuda.synchronize()
    mask = attention_mask(sq, skv, causal, window, device="cuda")
    valid = torch.ones_like(sc, dtype=torch.bool) if mask is None else mask.expand(sc.shape)
    assert torch.equal(int_softmax_block(sc, valid, BEST), pr)
    kg = k.double().repeat_interleave(h // kvh, dim=0)
    vg = v.double().repeat_interleave(h // kvh, dim=0)
    qd = q.double()
    plain = d * 2.0 ** -24 * torch.einsum("hqd,hsd->hqs", qd.abs(), kg.abs())
    own = (_mma_steps_bound((qd[:, :, None] * kg[:, None]).transpose(-1, -2)[..., None])[..., 0]
           if dtype == torch.bfloat16 else plain)
    tol = (own + plain) * d ** -0.5 + 2 ** -22 * sc.abs()
    assert bool(((sc - wsc).abs() <= tol)[valid].all())
    p, wp = pr.to(dtype).double(), wpr.to(dtype).double()
    n = valid.sum(-1, keepdim=True).double()
    plain_pv = n * 2.0 ** -24 * torch.einsum("hqs,hsd->hqd", wp.abs(), vg.abs())
    own_pv = (_mma_steps_bound(p[..., None] * vg[:, None]) if dtype == torch.bfloat16
              else n * 2.0 ** -24 * torch.einsum("hqs,hsd->hqd", p.abs(), vg.abs()))
    tol_out = own_pv + plain_pv + torch.einsum("hqs,hsd->hqd", (p - wp).abs(), vg.abs())
    assert bool(((out.double() - want[0].double()).abs() <= tol_out * 1.001 + 1e-30).all())
