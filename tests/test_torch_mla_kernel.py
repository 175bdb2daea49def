"""K4, the absorbed-MLA paged decode, and the MLA pool and parameter layouts,
against the reference.

* K4's plain version against the reference's ``paged_attend_mla`` in
  interpret mode (as the reference's own tests run it) over the matrix of
  ``tests/test_paged_kernel.py::test_mla_kernel_bitexact`` (H 4, R 64, DR
  16; (BS, NLOG, T) in {(8, 4, 1), (16, 4, 3), (64, 2, 1)}; mixed tables
  with sentinels), bf16:
  - scores (tier b): torch's and XLA's bf16 products may sum in other
    orders, so each of the two rounded dots may be one bf16 ulp apart; a
    score is held to (ulp(latent dot) + ulp(rope dot)) x scale of the
    reference's jitted einsums;
  - probabilities, bitwise: the reference's Alg. 1 on the port's scores
    gives the port's probabilities;
  - outputs: within sum_j |p_j - p'_j| |c_j| (p' the reference's Alg. 1 on
    its own scores) plus one bf16 ulp of the output.
* f32 compute on the same matrix: the reference's kernel and the port's
  plain version within 1e-6 absolute (the reference's f32 paged kernel and
  its own gather path already disagree in the last bits on this jax: a
  listed seed failure).
* The MLA pool layouts and pool operations, bitwise against the reference:
  ``paged_write`` on [NB, BS, R] and [NB, BS, DR] pools, ``paged_scatter``,
  ``paged_copy_block`` and ``paged_prefix_view`` on {"c_kv", "k_rope"}.
* ``convert.params_from_numpy`` carries the reference's MLA tree to the
  tree the port's ``Model.init`` draws (keys, shapes, dtypes).
* A ``cuda`` case holds the CUDA kernel against its plain version; it skips
  without a card. (K4's split and its plan: ``tests/test_torch_mla_split.py``.)
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget, smoke_config as jsmoke
from repro.core.int_softmax import int_softmax as jint_softmax
from repro.core.precision import BEST as JBEST
from repro.kernels.paged_attention import ops as jops
from repro.models import attention as jatt
from repro.models import kv_cache as jkv
from repro.models.model import Model as JModel
from repro_torch.configs.registry import get_config, smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.precision import BEST
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_mla_ref
from repro_torch.models import attention as tatt
from repro_torch.models import kv_cache as tkv
from repro_torch.models.model import Model

torch.set_num_threads(2)

MATRIX = [(8, 4, 1), (16, 4, 3), (64, 2, 1)]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


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


def _inputs(bs, nlog, t, seed, H=4, R=64, DR=16):
    B = 3
    NB = B * nlog + 2
    r = np.random.default_rng(seed)
    q_lat = r.normal(size=(B, t, H, R)).astype(np.float32)
    q_rope = r.normal(size=(B, t, H, DR)).astype(np.float32)
    c_pool = r.normal(size=(NB, bs, R)).astype(np.float32)
    kr_pool = r.normal(size=(NB, bs, DR)).astype(np.float32)
    table, pos = _mixed_table(r, B, nlog, NB, bs, t)
    return q_lat, q_rope, c_pool, kr_pool, table, pos, (R // 2 + DR) ** -0.5


@jax.jit
def _ref_dots(q_lat, q_rope, c_pool, kr_pool, table):
    """The reference's two bf16 dots of ``_ref_mla`` / ``mla._mla_attend``,
    each [B, H, T, L], rounded to bf16 as its compiled einsums round them."""
    c_kv, k_rope = jatt.paged_gather(c_pool, table), jatt.paged_gather(kr_pool, table)
    return (jnp.einsum("bqhr,blr->bhql", q_lat, c_kv),
            jnp.einsum("bqhd,bld->bhql", q_rope, k_rope))


@jax.jit
def _ref_scores(q_lat, q_rope, c_pool, kr_pool, table, scale):
    s1, s2 = _ref_dots(q_lat, q_rope, c_pool, kr_pool, table)
    return (s1 + s2).astype(jnp.float32) * scale


def _ulp_bf16(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("bs,nlog,t", MATRIX)
def test_k4_plain_matches_reference_kernel_bf16(bs, nlog, t):
    q_lat, q_rope, c_pool, kr_pool, table, pos, scale = _inputs(bs, nlog, t, seed=bs + t)
    B, _, H, R = q_lat.shape
    rows = t * H
    J = [jnp.asarray(x, jnp.bfloat16) for x in (q_lat, q_rope, c_pool, kr_pool)]
    want = jops.paged_attend_mla(*J, jnp.asarray(table), jnp.asarray(pos), JBEST,
                                 scale=scale, interpret=True)
    T = [_t(x, torch.bfloat16) for x in (q_lat, q_rope, c_pool, kr_pool)]
    out, sc, pr = paged_attention_mla_ref(
        T[0].reshape(B, rows, R), T[1].reshape(B, rows, -1), T[2], T[3], _t(table),
        _t(pos), BEST, scale=scale, return_rows=True)

    def rows_of(x):                              # [B, H, T, L] -> [B, ROWS, L]
        x = np.asarray(x, np.float32)
        return x.transpose(0, 2, 1, 3).reshape(B, rows, -1)

    # scores: each rounded dot within one bf16 ulp
    s1, s2 = _ref_dots(*J, jnp.asarray(table))
    want_sc = rows_of(_ref_scores(*J, jnp.asarray(table), scale))
    tol = (_ulp_bf16(rows_of(s1)) + _ulp_bf16(rows_of(s2))) * scale
    assert (np.abs(sc.numpy() - want_sc) <= tol).all()
    # where both of the port's rounded dots equal the reference's, the score
    # is bitwise their f32 sum, scaled, as the Pallas body adds them (a bf16
    # add of the two dots fails here)
    c_kv, k_rope = tatt.paged_gather(T[2], _t(table)), tatt.paged_gather(T[3], _t(table))
    t1 = torch.einsum("bqhr,blr->bhql", T[0], c_kv).float().numpy()
    t2 = torch.einsum("bqhd,bld->bhql", T[1], k_rope).float().numpy()
    r1, r2 = np.asarray(s1, np.float32), np.asarray(s2, np.float32)
    same = rows_of((t1 == r1) & (t2 == r2)).astype(bool)
    assert same.mean() > 0.99
    semi = rows_of((r1 + r2) * np.float32(scale))
    np.testing.assert_array_equal(sc.numpy()[same], semi[same])
    # probabilities: the reference's Alg. 1 on the port's scores, bitwise
    kpos = np.arange(nlog * bs)
    valid = kpos[None, None, :] <= np.repeat(pos, H, axis=1)[:, :, None]
    again = jint_softmax(jnp.asarray(sc.numpy()), cfg=JBEST, mask=jnp.asarray(valid), axis=-1)
    np.testing.assert_array_equal(np.asarray(again), pr.numpy())
    # outputs
    want_pr = np.asarray(jint_softmax(jnp.asarray(want_sc), cfg=JBEST,
                                      mask=jnp.asarray(valid), axis=-1))
    c = np.asarray(jatt.paged_gather(J[2], jnp.asarray(table)), np.float64)   # [B, L, R]
    dp = np.abs(pr.to(torch.bfloat16).double().numpy()
                - want_pr.astype(jnp.bfloat16).astype(np.float64))
    got, ref = out.float().numpy(), np.asarray(want, np.float32).reshape(B, rows, R)
    bound = np.einsum("brl,blk->brk", dp, np.abs(c)) + _ulp_bf16(np.maximum(np.abs(got),
                                                                             np.abs(ref)))
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("bs,nlog,t", MATRIX)
def test_k4_plain_matches_reference_kernel_f32(bs, nlog, t):
    q_lat, q_rope, c_pool, kr_pool, table, pos, scale = _inputs(bs, nlog, t, seed=7 + bs)
    want = jops.paged_attend_mla(*[jnp.asarray(x) for x in (q_lat, q_rope, c_pool, kr_pool)],
                                 jnp.asarray(table), jnp.asarray(pos), JBEST, scale=scale,
                                 interpret=True)
    got = ops.paged_attend_mla(*[_t(x) for x in (q_lat, q_rope, c_pool, kr_pool)],
                               _t(table), _t(pos), BEST, scale=scale)
    assert got.dtype == torch.float32 and got.shape == q_lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_k4_wrapper_on_cpu_runs_the_plain_rows_without_a_launch():
    q_lat, q_rope, c_pool, kr_pool, table, pos, scale = _inputs(16, 4, 3, seed=3)
    B, t, H, R = q_lat.shape
    T = [_t(x, torch.bfloat16) for x in (q_lat, q_rope, c_pool, kr_pool)]
    args = (T[0].reshape(B, t * H, R), T[1].reshape(B, t * H, -1), T[2], T[3], _t(table),
            _t(pos), BEST)
    before = ops.paged_attention_mla_rows.launches
    sc = torch.zeros((B, t * H, 4 * 16))
    pr = torch.zeros_like(sc)
    out = ops.paged_attention_mla_rows(*args, scale=scale, scores_out=sc, probs_out=pr)
    assert ops.paged_attention_mla_rows.launches == before
    want, want_sc, want_pr = paged_attention_mla_ref(*args, scale=scale, return_rows=True)
    assert torch.equal(out, want) and torch.equal(sc, want_sc) and torch.equal(pr, want_pr)
    # each row's probabilities sum to ~1 over its valid positions only
    qpos = np.repeat(pos, H, axis=1)
    for b in range(B):
        for r in range(t * H):
            assert float(pr[b, r, qpos[b, r] + 1:].abs().sum()) == 0.0
    np.testing.assert_allclose(pr.sum(-1).numpy(), 1.0, atol=1e-4)


# ------------------------------------------------------------ pools and params


def test_mla_pool_write_and_gather_match_reference():
    nb, bs, n_log, b = 7, 4, 3, 4
    rng = np.random.default_rng(0)
    table = np.array([[2, 5, nb], [0, nb, nb], [6, 1, 3], [4, nb, nb]], np.int32)
    pos = np.array([5, 6, n_log * bs, 2], np.int32)    # lands, sentinel, parked, lands
    for width in (64, 16):                               # latent [.., R], rope key [.., DR]
        pool = rng.normal(size=(nb, bs, width)).astype(np.float32)
        new = rng.normal(size=(b, width)).astype(np.float32)
        want = jatt.paged_write(jnp.asarray(pool), jnp.asarray(table), jnp.asarray(new),
                                jnp.asarray(pos))
        got = tatt.paged_write(_t(pool), _t(table), _t(new), _t(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tatt.paged_gather(got, _t(table)).numpy(),
                                      np.asarray(jatt.paged_gather(want, jnp.asarray(table))))


def test_mla_pool_ops_match_reference():
    tcfg, jcfg = tsmoke("minicpm3-4b"), jsmoke("minicpm3-4b")
    slots, cache_len, bs, nb = 2, 16, 4, 9
    tc = tkv.paged_cache_zeros(tcfg, slots, cache_len, bs, nb)
    jc = jkv.paged_cache_zeros(jcfg, slots, cache_len, bs, nb)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["c_kv"].shape == (3, nb, bs, 64) and tc["k_rope"].shape == (3, nb, bs, 16)
    assert tkv.cache_zeros(tcfg, 2, 16)["c_kv"].shape == (3, 2, 16, 64)
    rng = np.random.default_rng(1)
    for k in ("c_kv", "k_rope"):
        vals = rng.normal(size=tc[k].shape).astype(np.float32)
        tc[k], jc[k] = _t(vals, torch.bfloat16), jnp.asarray(vals, jnp.bfloat16)
    vals = {k: rng.normal(size=(3, 1, 7, tc[k].shape[-1])).astype(np.float32)
            for k in ("c_kv", "k_rope")}
    ids = np.array([6, 2], np.int32)
    row = np.array([6, 2, 9, 9], np.int32)
    wpos = np.arange(1, 7)
    pb, off = ids[wpos // 4], (wpos % 4).astype(np.int32)
    jc = jkv.paged_scatter(jc, {k: jnp.asarray(v) for k, v in vals.items()}, jnp.int32(1),
                           jnp.asarray(row), jnp.asarray(pb), jnp.asarray(off), t0=1, t1=7)
    tkv.paged_scatter(tc, {k: _t(v) for k, v in vals.items()}, 1, row, pb, off, 1, 7)
    jc = jkv.paged_copy_block(jc, jnp.int32(2), jnp.int32(4))
    tkv.paged_copy_block(tc, 2, 4)
    want = jkv.paged_prefix_view(jc, jnp.asarray(ids), s=6)
    got = tkv.paged_prefix_view(tc, ids, 6)
    for a, b in ((tc, jc), (got, want)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].float().numpy(),
                                          np.asarray(jnp.asarray(b[k], jnp.float32)))


@pytest.mark.parametrize("q_lora", [64, 0])
def test_convert_carries_the_mla_tree(q_lora):
    """The reference's MLA parameters land in the tree ``Model.init`` draws:
    the same keys and shapes, weights in the compute dtype, norm scales f32
    (with and without the query's low-rank projection)."""
    jcfg = dataclasses.replace(jsmoke("minicpm3-4b"), q_lora_rank=q_lora)
    tcfg = dataclasses.replace(tsmoke("minicpm3-4b"), q_lora_rank=q_lora)
    jp = JModel(jcfg, dtype=jnp.float32).init_split(jax.random.PRNGKey(0))[0]
    got = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.bfloat16)
    drawn = Model(tcfg, dtype=torch.bfloat16, device="cpu").init(torch.Generator().manual_seed(0))

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                for k, v in tree.items()}

    assert sig(got) == sig(drawn)
    attn = got["stack"]["layers"]["attn"]
    assert ("wdq" in attn) == bool(q_lora) and ("wq" in attn) == (not q_lora)
    assert attn["kv_norm"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        attn["wuk"]["w"].float().numpy(),
        np.asarray(jnp.asarray(jp["stack"]["layers"]["attn"]["wuk"]["w"], jnp.bfloat16),
                   np.float32))


def test_minicpm3_config_is_the_reference_config():
    t, j = get_config("minicpm3-4b"), jget("minicpm3-4b")
    fields = [f.name for f in dataclasses.fields(t) if f.name != "softmax"]
    assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}
    assert abs(t.param_count() - 4.26e9) < 0.01e9
    s, js = tsmoke("minicpm3-4b"), jsmoke("minicpm3-4b")
    assert {f: getattr(s, f) for f in fields} == {f: getattr(js, f) for f in fields}


# ------------------------------------------------------------ on the card


U = 2.0 ** -24 * (1 + 2.0 ** -8)            # f32 unit roundoff, with room for its own rounding
# One tensor-core step adds 16 exact bf16 products to the accumulator in
# fused groups of g <= 16 products; a group that keeps 24 bits of its
# largest addend and truncates loses < 2^-23 (g max + |result|), so the step
# < (16 + 16 / g) 2^-23 <= 32 2^-23 times (|partial before the step| + sum
# |products|). Round-to-nearest is inside this bound.
MMA_U = 32 * 2.0 ** -23 * (1 + 2.0 ** -8)


def _k4_tree(p, c, pos, bs, nlog, rows, mma):
    """The exact f64 sum of p [B, ROWS, L] (compute-dtype values) times the
    latent rows c [B, L, R], and the bound of K4's summation tree, each [B,
    ROWS, R]: inside each chunk of its split (``ref.k4_split_plan`` on this
    card) key by key in f32 (U per partial sum) or, in bf16 on tensor
    cores, 16 keys a step (MMA_U per step); then the chunk partials added
    in chunk order (U per sum after the first)."""
    from repro_torch.kernels.paged_attention.ref import k2_chunks, k2_span, k4_split_plan

    B = p.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cp = k4_split_plan(B, rows, nlog, bs, sms, pos.shape[1])
    exact = torch.zeros(p.shape[:2] + c.shape[-1:], dtype=torch.float64, device=p.device)
    bound = torch.zeros_like(exact)
    for b, prow in enumerate(pos.tolist()):
        for i, (lo, hi) in enumerate(k2_chunks(*k2_span(prow, nlog, bs), cp)):
            terms = p[b, :, lo * bs:hi * bs, None] * c[b, None, lo * bs:hi * bs]
            if mma:
                steps = torch.nn.functional.pad(terms, (0, 0, 0, (-terms.shape[1]) % 16))
                steps = steps.reshape(rows, -1, 16, terms.shape[-1])
                step, mass = steps.sum(2), steps.abs().sum(2)
                before = torch.cumsum(step, 1) - step
                bound[b] += MMA_U * (before.abs() + mass).sum(1)
            else:
                bound[b] += U * torch.cumsum(terms, 1).abs().sum(1)
            exact[b] += terms.sum(1)
            if i:
                bound[b] += U * exact[b].abs()
    return exact, bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,nlog,t", MATRIX)
def test_k4_kernel_matches_plain_on_card(dtype, bs, nlog, t):
    """The CUDA kernel against its plain version: the plain Alg. 1 on the
    kernel's own scores gives its probabilities bitwise; each output within
    the bound of the kernel's summation tree (``_k4_tree``) plus half an ulp
    of the exact sum over its own compute-dtype probabilities, and within
    sum_j |p_j - p'_j| |c_j|, both summation bounds and one ulp of the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    q_lat, q_rope, c_pool, kr_pool, table, pos, scale = _inputs(bs, nlog, t, seed=bs * t)
    B, _, H, R = q_lat.shape
    rows, L = t * H, nlog * bs
    dev = "cuda"
    T = [_t(x, dtype).to(dev) for x in (q_lat, q_rope, c_pool, kr_pool)]
    args = (T[0].reshape(B, rows, R), T[1].reshape(B, rows, -1), T[2], T[3],
            _t(table).to(dev), _t(pos).to(dev), BEST)
    sc = torch.zeros((B, rows, L), device=dev)
    pr = torch.zeros_like(sc)
    out = ops.paged_attention_mla_rows(*args, scale=scale, scores_out=sc, probs_out=pr)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want, _, want_pr = paged_attention_mla_ref(*args, scale=scale, return_rows=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    valid = (torch.arange(L, device=dev)
             <= _t(np.repeat(pos, H, axis=1)).to(dev)[:, :, None])
    again = int_softmax_ref(sc.reshape(-1, L), BEST, valid.reshape(-1, L)).reshape(sc.shape)
    assert torch.equal(again, pr)

    mantissa = 7 if dtype == torch.bfloat16 else 23

    def ulp(x):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - mantissa)

    c = tatt.paged_gather(T[2], args[4]).double()[:, None]        # [B, 1, L, R]
    exact, recursive = _k4_tree(pr.to(dtype).double(), c[:, 0], pos, bs, nlog, rows,
                                dtype == torch.bfloat16)
    plain_sum = (valid.sum(-1, keepdim=True).double() * 2.0 ** -24
                 * (want_pr.to(dtype).double()[..., None] * c).abs().sum(dim=2))
    dp = ((pr.to(dtype).double() - want_pr.to(dtype).double()).abs()[..., None]
          * c.abs()).sum(dim=2)
    o, w = out.double(), want.double()
    tol_pv = recursive + 0.5 * ulp(torch.maximum(o.abs(), exact.abs() + recursive))
    assert bool(((o - exact).abs() <= tol_pv).all())
    tol = dp + recursive + plain_sum + ulp(torch.maximum(o.abs(), w.abs()))
    assert bool(((o - w).abs() <= tol).all())
