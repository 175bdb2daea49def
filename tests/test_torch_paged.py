"""The port's paged KV cache and the fused paged decode (K2) against the
reference, and the port's own paged invariants.

* Pool primitives, bitwise against JAX: ``paged_write`` / ``paged_gather``
  (parked rows and sentinel entries drop; sentinels gather as zeros),
  ``paged_scatter``, ``paged_copy_block``, ``paged_prefix_view``.
* K2's plain version against the reference's ``paged_attend_dense`` in
  interpret mode (as the reference's own tests run it) over the matrix of
  ``tests/test_paged_kernel.py`` without int8 (int8 pools:
  ``tests/test_torch_kvquant.py``): bitwise in bf16. In f32 the
  reference's kernel and its own gather path disagree in the last bits on
  this jax (a listed seed failure), so f32 is held to 1e-6 absolute.
* Inside the port, bitwise: paged decode == contiguous decode (gather and
  fused paths), and ``prefill_tail`` == the tail slice of a whole prefill.
* ``cuda`` cases hold the CUDA kernel against its plain version; they skip
  without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.precision import BEST as JBEST
from repro.kernels.paged_attention import ops as jops
from repro.models import attention as jatt
from repro.models import kv_cache as jkv
from repro.configs.registry import smoke_config as jsmoke
from repro_torch.configs.registry import smoke_config as tsmoke
from repro_torch.core.precision import BEST
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    k2_chunks, k2_span, k2_split_plan, paged_attention_ref,
)
from repro_torch.models import attention as tatt
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import Model

torch.set_num_threads(2)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


# ------------------------------------------------------------ pool primitives


def test_paged_write_gather_roundtrip_parking_and_sentinels():
    nb, bs, n_log, b, d = 7, 4, 3, 4, 5
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(nb, bs, d)).astype(np.float32)
    table = np.array([[2, 5, nb], [0, nb, nb], [6, 1, 3], [4, nb, nb]], np.int32)
    new = rng.normal(size=(b, d)).astype(np.float32)
    # row 0 writes page 1; row 1 lands on a sentinel (dropped); row 2 is
    # parked at cache_len (dropped); row 3 writes page 0
    pos = np.array([5, 6, n_log * bs, 2], np.int32)
    want = jatt.paged_write(jnp.asarray(pool), jnp.asarray(table),
                            jnp.asarray(new), jnp.asarray(pos))
    got = tatt.paged_write(_t(pool), _t(table), _t(new), _t(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tatt.paged_gather(got, _t(table)).numpy(),
        np.asarray(jatt.paged_gather(want, jnp.asarray(table))))
    # an int position for the whole batch, and a batch where nothing lands
    for p in (1, n_log * bs):
        w = jatt.paged_write(jnp.asarray(pool), jnp.asarray(table),
                             jnp.asarray(new), p)
        g = tatt.paged_write(_t(pool), _t(table), _t(new), p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cfg():
    return tsmoke("olmo-1b"), jsmoke("olmo-1b")


def _pool_pair(seed=0, slots=2, cache_len=16, bs=4, nb=9):
    tcfg, jcfg = _cfg()
    rng = np.random.default_rng(seed)
    tc = tkv.paged_cache_zeros(tcfg, slots, cache_len, bs, nb)
    jc = jkv.paged_cache_zeros(jcfg, slots, cache_len, bs, nb)
    for k in ("k", "v"):
        vals = rng.normal(size=tc[k].shape).astype(np.float32)
        tc[k] = _t(vals, torch.bfloat16)
        jc[k] = jnp.asarray(vals, jnp.bfloat16)
    return tcfg, tc, jc


def _same_cache(tc, jc):
    for k in tc:
        np.testing.assert_array_equal(_np(tc[k]), _np(jc[k]))


def test_paged_scatter_copy_and_prefix_view_match_reference():
    tcfg, tc, jc = _pool_pair()
    rng = np.random.default_rng(1)
    L, kv, dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.d_head
    vals = rng.normal(size=(L, 1, 7, kv, dh)).astype(np.float32)
    ids = np.array([6, 2], np.int32)
    row = np.array([6, 2, 9, 9], np.int32)
    wpos = np.arange(1, 7)               # positions [1, 7) of a 7-token prefill
    pb, off = ids[wpos // 4], (wpos % 4).astype(np.int32)
    jc = jkv.paged_scatter(jc, {"k": jnp.asarray(vals), "v": jnp.asarray(vals)},
                           jnp.int32(1), jnp.asarray(row), jnp.asarray(pb),
                           jnp.asarray(off), t0=1, t1=7)
    tkv.paged_scatter(tc, {"k": _t(vals), "v": _t(vals)}, 1, row, pb, off, 1, 7)
    _same_cache(tc, jc)
    jc = jkv.paged_copy_block(jc, jnp.int32(2), jnp.int32(4))
    tkv.paged_copy_block(tc, 2, 4)
    _same_cache(tc, jc)
    want = jkv.paged_prefix_view(jc, jnp.asarray(ids), s=6)
    got = tkv.paged_prefix_view(tc, ids, 6)
    _same_cache(got, want)
    # the view is a copy: a later pool write leaves it as it was
    before = got["k"].clone()
    tc["k"].zero_()
    assert torch.equal(got["k"], before)


def test_paged_scatter_drops_out_of_pool_coordinates():
    tcfg, tc, jc = _pool_pair(seed=2)
    L, kv, dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.d_head
    vals = np.random.default_rng(3).normal(size=(L, 1, 3, kv, dh)).astype(np.float32)
    row = np.array([1, 9, 9, 9], np.int32)
    pb, off = np.array([1, 9, 1], np.int32), np.array([0, 1, 2], np.int32)
    jc = jkv.paged_scatter(jc, {"k": jnp.asarray(vals), "v": jnp.asarray(vals)},
                           jnp.int32(0), jnp.asarray(row), jnp.asarray(pb),
                           jnp.asarray(off), t0=0, t1=3)
    tkv.paged_scatter(tc, {"k": _t(vals), "v": _t(vals)}, 0, row, pb, off, 0, 3)
    _same_cache(tc, jc)


# ------------------------------------------------------------ K2, plain version


def _mixed_table(rng, B, NLOG, NB, BS, T):
    """As ``tests/test_paged_kernel.py``: per-row tables with a random live
    prefix and NB sentinels after it; positions inside the live region."""
    table = np.full((B, NLOG), NB, np.int32)
    perm = rng.permutation(NB)
    pi = 0
    positions = np.zeros((B, T), np.int32)
    for b in range(B):
        npages = int(rng.integers(1, NLOG + 1))
        table[b, :npages] = perm[pi:pi + npages]
        pi += npages
        positions[b] = int(rng.integers(0, npages * BS)) + np.arange(T)
    return table, positions


def _k2_pair(bs, nlog, t, kvh, window, dtype, seed):
    B, H, D = 3, 4, 32
    NB = B * nlog + 2
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, t, H, D)).astype(np.float32)
    k = r.normal(size=(NB, bs, kvh, D)).astype(np.float32)
    v = r.normal(size=(NB, bs, kvh, D)).astype(np.float32)
    table, pos = _mixed_table(r, B, nlog, NB, bs, t)
    jd, td = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
              "float32": (jnp.float32, torch.float32)}[dtype]
    want = jops.paged_attend_dense(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(table), jnp.asarray(pos), JBEST, scale=D ** -0.5,
        window=window, interpret=True)
    got = ops.paged_attend_dense(_t(q, td), _t(k, td), _t(v, td), _t(table),
                                 _t(pos), BEST, scale=D ** -0.5, window=window)
    assert got.dtype == td and got.shape == (B, t, H, D)
    return _np(got), _np(want)


@pytest.mark.parametrize("bs,nlog", [(8, 4), (16, 4), (64, 2)])
@pytest.mark.parametrize("t", [1, 3])          # decode, verify rows
@pytest.mark.parametrize("kvh", [1, 2])        # GQA group 4, group 2
@pytest.mark.parametrize("window", [0, 12])
def test_k2_plain_matches_reference_kernel_bf16(bs, nlog, t, kvh, window):
    got, want = _k2_pair(bs, nlog, t, kvh, window, "bfloat16",
                         seed=bs * 100 + nlog * 10 + t + kvh + window)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bs,nlog", [(8, 3), (64, 2)])
@pytest.mark.parametrize("t,kvh,window", [(1, 2, 0), (3, 1, 12)])
def test_k2_plain_matches_reference_kernel_f32(bs, nlog, t, kvh, window):
    got, want = _k2_pair(bs, nlog, t, kvh, window, "float32", seed=7 + t + bs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_k2_wrapper_cpu_does_not_launch_and_rejects_int8():
    """No launch for CPU tensors; a scale without int8 pools (or one scale
    alone) is refused. Int8 pools with both scales are
    tests/test_torch_kvquant.py's."""
    before = ops.paged_attention_rows.launches
    _k2_pair(8, 2, 1, 2, 0, "bfloat16", seed=0)
    assert ops.paged_attention_rows.launches == before
    q = torch.zeros((1, 1, 2, 8))
    pool = torch.zeros((2, 4, 2, 8))
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        ops.paged_attend_dense(q, pool, pool, table, table[:, :1], BEST,
                               scale=1.0, k_scale=torch.ones((2, 4, 2)))


def test_k2_debug_rows_on_cpu_are_the_plain_rows():
    r = np.random.default_rng(4)
    q = _t(r.normal(size=(2, 2, 3, 16)).astype(np.float32), torch.bfloat16)
    k = _t(r.normal(size=(6, 4, 2, 16)).astype(np.float32), torch.bfloat16)
    v = _t(r.normal(size=(6, 4, 2, 16)).astype(np.float32), torch.bfloat16)
    table = _t(np.array([[0, 3, 6], [5, 6, 6]], np.int32))
    pos = _t(np.array([[9], [2]], np.int32))
    sc = torch.zeros((2, 2, 3, 12))
    pr = torch.zeros_like(sc)
    out = ops.paged_attention_rows(q, k, v, table, pos, BEST, scale=0.25,
                                   scores_out=sc, probs_out=pr)
    want, want_sc, want_pr = paged_attention_ref(q, k, v, table, pos, BEST,
                                                 scale=0.25, return_rows=True)
    assert torch.equal(out, want) and torch.equal(sc, want_sc)
    assert torch.equal(pr, want_pr)
    assert float(pr[1, :, :, 3:].abs().max()) == 0.0   # masked past qpos 2
    np.testing.assert_allclose(pr.sum(-1).numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------------ model, in the port


@pytest.fixture(scope="module")
def model_bf16():
    cfg = tsmoke("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    m = Model(cfg, dtype=torch.bfloat16, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _paged_from_contiguous(cache, bs, perm):
    """The same cache contents in a paged pool with shuffled blocks."""
    L, b, c, kv, dh = cache["k"].shape
    nlog = c // bs
    nb = b * nlog + 3
    out = {"table": torch.full((L, b, nlog), nb, dtype=torch.int32)}
    for k in ("k", "v"):
        pool = torch.zeros((L, nb, bs, kv, dh), dtype=cache[k].dtype)
        for s in range(b):
            for j in range(nlog):
                pool[:, perm[s * nlog + j]] = cache[k][:, s, j * bs:(j + 1) * bs]
        out[k] = pool
    for s in range(b):
        out["table"][:, s] = torch.as_tensor(perm[s * nlog:(s + 1) * nlog])
    return out


@pytest.mark.parametrize("kind", ["int_pallas", "int_pallas_paged"])
def test_paged_decode_equals_contiguous(model_bf16, kind):
    """Four decode steps at per-slot positions (one slot parked) through a
    paged pool give the contiguous path's logits and cache contents bit for
    bit — gathered (int_pallas) and through K2's plain version
    (int_pallas_paged)."""
    m, params = model_bf16
    m = Model(m.cfg.with_softmax(SoftmaxSpec(kind)), dtype=torch.bfloat16,
              device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, m.cfg.vocab, (3, 6)))
    _, cont = m.prefill(params, {"tokens": tokens}, cache_len=16)
    cont = {k: v.to(torch.bfloat16) for k, v in cont.items()}
    paged = _paged_from_contiguous(cont, 4, rng.permutation(3 * 4 + 3))
    pos = torch.tensor([6, 9, 16], dtype=torch.int32)     # slot 2 parked
    for step in range(4):
        tok = torch.as_tensor(rng.integers(0, m.cfg.vocab, (3, 1)))
        lc, _ = m.decode_step(params, cont, {"token": tok}, pos)
        lp, _ = m.decode_step(params, paged, {"token": tok}, pos)
        assert torch.equal(lc[:2], lp[:2]), step
        pos = pos + torch.tensor([1, 1, 0], dtype=torch.int32)
    back = tatt.paged_gather(paged["k"][0], paged["table"][0])
    assert torch.equal(back[:2, :11], cont["k"][0, :2, :11])


@pytest.mark.parametrize("s", [4, 7, 12])
def test_prefill_tail_equals_whole_prefill(model_bf16, s):
    m, params = model_bf16
    tokens = torch.as_tensor(np.random.default_rng(s).integers(0, m.cfg.vocab, (1, 15)))
    lw, whole = m.prefill(params, {"tokens": tokens}, cache_len=15)
    prefix = {k: v[:, :, :s].to(torch.bfloat16) for k, v in whole.items()}
    lt, tail = m.prefill_tail(params, {"tokens": tokens[:, s:]}, prefix, s)
    assert torch.equal(lt, lw)
    for k in ("k", "v"):
        assert torch.equal(tail[k], whole[k][:, :, s:15])


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,t,kvh,window", [(16, 1, 2, 0), (8, 3, 1, 12), (64, 1, 2, 0)])
def test_k2_kernel_matches_plain_on_card(dtype, bs, t, kvh, window):
    """The CUDA kernel against its plain version: the plain Alg. 1 on the
    kernel's own scores gives its probabilities bitwise. Outputs: within
    the bound of its summation tree (2^-24 x sum_i |partial sum i| key by
    key inside each chunk of its split, plus 2^-24 x |chunk partials added
    so far| for each chunk after the first) plus half an ulp of the exact
    sum over its own compute-dtype probabilities;
    within sum_j |p_j - p'_j| |v_j| (a score one ulp off may move an Alg.-1
    code), both f32 summation bounds and one ulp of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    r = np.random.default_rng(bs + t)
    S, H, D, nlog = 3, 4, 64, 8
    nb = S * nlog + 1
    table, pos = _mixed_table(r, S, nlog, nb, bs, t)
    dev = "cuda"
    q = _t(r.normal(size=(S, kvh, t * (H // kvh), D)).astype(np.float32), dtype).to(dev)
    k = _t(r.normal(size=(nb, bs, kvh, D)).astype(np.float32), dtype).to(dev)
    v = _t(r.normal(size=(nb, bs, kvh, D)).astype(np.float32), dtype).to(dev)
    table, pos = _t(table).to(dev), _t(pos).to(dev)
    sc = torch.zeros((S, kvh, q.shape[2], nlog * bs), device=dev)
    pr = torch.zeros_like(sc)
    out = ops.paged_attention_rows(q, k, v, table, pos, BEST, scale=D ** -0.5,
                                   window=window, scores_out=sc, probs_out=pr)
    # the plain version's products with f32 accumulation throughout
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want, _, want_pr = paged_attention_ref(q, k, v, table, pos, BEST,
                                               scale=D ** -0.5, window=window,
                                               return_rows=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    kpos = torch.arange(nlog * bs, device=dev)
    qp = pos.repeat_interleave(H // kvh, dim=1)[:, None, :, None]
    valid = kpos <= qp
    if window:
        valid &= kpos > qp - window
    valid = valid.expand(sc.shape)
    again = int_softmax_ref(sc.reshape(-1, nlog * bs), BEST,
                            valid.reshape(-1, nlog * bs)).reshape(sc.shape)
    assert torch.equal(again, pr)

    mantissa = 7 if dtype == torch.bfloat16 else 23

    def ulp(x):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                          - mantissa)

    vg = tatt.paged_gather(v, table).double().permute(0, 2, 1, 3)[:, :, None]
    terms = pr.to(dtype).double()[..., None] * vg                 # [S, KV, ROWS, L, Dv]
    # the kernel's summation tree: key order inside each chunk of its split,
    # then the chunk partials in chunk order
    cp = k2_split_plan(S, kvh, q.shape[2], nlog, bs,
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       pos.shape[1])
    exact = torch.zeros_like(terms[:, :, :, 0])
    recursive = torch.zeros_like(exact)
    for s, prow in enumerate(pos.cpu().tolist()):
        for c, (a, b) in enumerate(k2_chunks(*k2_span(prow, nlog, bs, window), cp)):
            part = torch.cumsum(terms[s, :, :, a * bs:b * bs], dim=2)
            recursive[s] += part.abs().sum(dim=2)
            exact[s] += part[:, :, -1]
            if c:
                recursive[s] += exact[s].abs()
    recursive *= 2.0 ** -24 * (1 + 2.0 ** -8)
    plain_sum = (valid.sum(-1, keepdim=True).double() * 2.0 ** -24
                 * (want_pr.to(dtype).double()[..., None] * vg).abs().sum(dim=3))
    dp = ((pr.to(dtype).double() - want_pr.to(dtype).double()).abs()[..., None]
          * vg.abs()).sum(dim=3)
    o, w = out.double(), want.double()
    tol_pv = recursive + 0.5 * ulp(torch.maximum(o.abs(), exact.abs() + recursive))
    assert bool(((o - exact).abs() <= tol_pv).all())
    tol = dp + recursive + plain_sum + ulp(torch.maximum(o.abs(), w.abs()))
    assert bool(((o - w).abs() <= tol).all())
