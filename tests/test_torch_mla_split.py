"""K4's split over CTAs, checked on the CPU through its plain split version.

The CUDA kernel (``csrc/paged_attention_mla.cu``) cuts each slot's live
pages into chunks (``ref.k4_split_plan`` / ``k2_chunks``) and runs Alg. 1 in
exact passes: per-chunk maxima combined into the row max, per-chunk integer
sums, per-chunk f32 PV partials added in chunk order.
``paged_attention_mla_ref(..., chunk_pages=p)`` mirrors that partition;
these tests hold it:

* its probabilities bitwise equal to the whole-row plain version's and to
  the reference's Alg. 1 on its scores, the check
  ``tests/test_torch_mla_kernel.py`` makes against the JAX
  ``paged_attend_mla`` run in interpret mode; its outputs within the
  two-level f32 bound of its summation tree of the exact f64 sum, and
  within the probability differences times |c| plus both sums' bounds of
  the JAX kernel's, over chunks of 1 page, 3 pages and the whole span;
* the plan at the shapes ``chip_smoke.py`` runs: every page of the span in
  exactly one chunk, in order, no sentinel page loaded, nothing outside the
  span needed by any row, the grid covering the card, each latent page read
  once per slot and head tile at the serve shape;
* the two faults ``chip_smoke.py --fault-control`` patches in are seen by
  these checks;
* on a card, the CUDA kernel against the plain split version (skips here).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.int_softmax import int_softmax as jint_softmax
from repro.core.precision import BEST as JBEST
from repro.kernels.paged_attention import ops as jops
from repro.models import attention as jatt
from repro_torch.core.precision import BEST
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.ref import (
    k2_chunks, k2_span, k4_split_plan, paged_attention_mla_ref,
)
from repro_torch.models.attention import paged_gather

torch.set_num_threads(2)

U = 2.0 ** -24 * (1 + 2.0 ** -8)          # f32 unit roundoff, with room for its own rounding
R, DR = 64, 16                            # the reference matrix's widths

# scenario -> (B, T, H, BS, NLOG, parked slot, all-masked slot)
SCENARIOS = {
    "decode": (3, 1, 4, 8, 6, None, None),
    "sentinel tails": (4, 1, 2, 4, 9, None, None),
    "parked slot": (3, 1, 4, 8, 6, 1, None),
    "all-masked row": (3, 1, 4, 8, 6, None, 2),
    "T 3": (3, 3, 4, 8, 6, None, None),
    "block size 16": (3, 1, 4, 16, 4, None, None),
}
CHUNKS = {"1 page": 1, "3 pages": 3, "whole span": None}   # None: NLOG pages


@jax.jit
def _ref_scores(q_lat, q_rope, c_pool, kr_pool, table, scale):
    """The reference's scores [B, H, T, L]: its two bf16 dots added in f32."""
    c_kv, k_rope = jatt.paged_gather(c_pool, table), jatt.paged_gather(kr_pool, table)
    s1 = jnp.einsum("bqhr,blr->bhql", q_lat, c_kv)
    s2 = jnp.einsum("bqhd,bld->bhql", q_rope, k_rope)
    return (s1 + s2).astype(jnp.float32) * scale


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy inputs of a scenario, the JAX kernel's bf16 output (interpret
    mode) and probabilities, and the torch tensors in the kernel's layout."""
    b, t, h, bs, nlog, parked, masked = SCENARIOS[name]
    nb = b * nlog + 2
    r = np.random.default_rng(sorted(SCENARIOS).index(name))
    q_lat = r.normal(size=(b, t, h, R)).astype(np.float32)
    q_rope = r.normal(size=(b, t, h, DR)).astype(np.float32)
    c_pool = r.normal(size=(nb, bs, R)).astype(np.float32)
    kr_pool = r.normal(size=(nb, bs, DR)).astype(np.float32)
    table = np.full((b, nlog), nb, np.int32)
    pos = np.zeros((b, t), np.int32)
    perm = r.permutation(nb)
    used = 0
    for s in range(b):
        if s == parked:                      # parked at the cache length, no pages
            pos[s] = nlog * bs
            continue
        npages = int(r.integers(2, nlog + 1))
        table[s, :npages] = perm[used:used + npages]
        used += npages
        pos[s] = int(r.integers(0, npages * bs - t + 1)) + np.arange(t)
        if s == masked:                      # no key at or below any query
            pos[s] = -1 - np.arange(t)
    scale = (R // 2 + DR) ** -0.5
    J = [jnp.asarray(x, jnp.bfloat16) for x in (q_lat, q_rope, c_pool, kr_pool)]
    want = jops.paged_attend_mla(*J, jnp.asarray(table), jnp.asarray(pos), JBEST, scale=scale,
                                 interpret=True)
    rows = t * h
    valid = np.arange(nlog * bs)[None, None, :] <= np.repeat(pos, h, axis=1)[:, :, None]
    want_pr = jint_softmax(_ref_scores(*J, jnp.asarray(table), scale), cfg=JBEST,
                           mask=jnp.asarray(valid.reshape(b, t, h, -1).transpose(0, 2, 1, 3)),
                           axis=-1)
    want_pr = np.array(want_pr).transpose(0, 2, 1, 3).reshape(b, rows, -1)
    T = [torch.from_numpy(x).to(torch.bfloat16) for x in (q_lat, q_rope, c_pool, kr_pool)]
    return dict(args=(T[0].reshape(b, rows, R), T[1].reshape(b, rows, DR), T[2], T[3],
                      torch.from_numpy(table), torch.from_numpy(pos), BEST),
                scale=scale, valid=valid, nlog=nlog, bs=bs,
                want=torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))).reshape(
                    b, rows, R).double(),
                want_pr=torch.from_numpy(want_pr))


def _run(c, chunk_pages):
    return paged_attention_mla_ref(*c["args"], scale=c["scale"], chunk_pages=chunk_pages,
                                   return_rows=True)


def _tree(c, probs, cp):
    """The exact f64 sum over the bf16 probabilities and the two-level f32
    bound of the split's summation tree: any order of the n keys inside a
    chunk (n u sum |p c|), then the partials added in chunk order from 0
    (u |partials added so far| after the first). [S, ROWS, R] each."""
    lat = paged_gather(c["args"][2], c["args"][4]).double()       # [S, L, R]
    p = probs.to(torch.bfloat16).double()                         # [S, ROWS, L]
    exact = torch.zeros(p.shape[:2] + (R,), dtype=torch.float64)
    bound = torch.zeros_like(exact)
    nlog, bs = c["nlog"], c["bs"]
    for s, prow in enumerate(c["args"][5].tolist()):
        for i, (a, b) in enumerate(k2_chunks(*k2_span(prow, nlog, bs), cp)):
            terms = p[s, :, a * bs:b * bs, None] * lat[s, None, a * bs:b * bs]
            bound[s] += (b - a) * bs * U * terms.abs().sum(1)
            exact[s] += terms.sum(1)
            if i:
                bound[s] += U * exact[s].abs()
    return exact, bound


def _ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_split_probs_bitwise_outputs_within_tree_bound(scenario, chunk):
    c = _case(scenario)
    cp = CHUNKS[chunk] or c["nlog"]
    out_w, sc_w, pr_w = _run(c, None)
    out, sc, pr = _run(c, cp)
    assert torch.equal(sc, sc_w)
    assert torch.equal(pr, pr_w), "split probabilities differ from the whole row's"
    # the reference's Alg. 1 on the split's scores gives its probabilities
    again = jint_softmax(jnp.asarray(sc.numpy()), cfg=JBEST, mask=jnp.asarray(c["valid"]),
                         axis=-1)
    np.testing.assert_array_equal(np.asarray(again), pr.numpy())
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    exact, bound = _tree(c, pr, cp)
    o = out.double()
    half = 0.5 * _ulp(torch.maximum(o.abs(), exact.abs()))
    assert bool(((o - exact).abs() <= bound + half).all())
    # the JAX kernel: its probabilities are the reference's Alg. 1 on its own
    # scores (a bf16 ulp of a dot apart from the port's); the outputs differ
    # by those differences times |c|, the two f32 sums (its own: n u sum |p
    # c| over the n keys of the row) and the two bf16 roundings
    lat = paged_gather(c["args"][2], c["args"][4]).double().abs()
    want, wp = c["want"], c["want_pr"].to(torch.bfloat16).double()
    dp = torch.einsum("srl,slk->srk", (pr.to(torch.bfloat16).double() - wp).abs(), lat)
    n = c["nlog"] * c["bs"]
    tol = dp + bound + n * U * torch.einsum("srl,slk->srk", wp, lat) + _ulp(
        torch.maximum(o.abs(), want.abs()))
    assert bool(((o - want).abs() <= tol).all())
    if scenario == "all-masked row":
        assert float(pr[2].abs().max()) == 0.0 and float(out[2].abs().max()) == 0.0


# name -> (slots, rows, NLOG, BS, positions per slot): the shapes chip_smoke.py's
# phase 7 runs, the reference matrix, and edge tables
PLANS = {
    "serve decode": (8, 40, 34, 16, [[400], [543], [433], [512], [470], [401], [530], [499]]),
    "4096-token rows": (4, 40, 256, 16, [[4095], [4000], [3000], [2049]]),
    "32768-token row": (1, 40, 2048, 16, [[32767]]),
    "T 3 at 4096": (2, 120, 256, 16, [[4093, 4094, 4095], [3000, 3001, 3002]]),
    "deepseek-v2 at 4096": (2, 128, 256, 16, [[4095], [3000]]),
    "reference matrix BS 8": (3, 4, 4, 8, [[0], [31], [17]]),
    "block size 64": (3, 4, 2, 64, [[127], [64], [63]]),
    "parked and empty": (3, 40, 6, 16, [[96], [-1], [40]]),
}
SMS = 132


@pytest.mark.parametrize("name", list(PLANS))
def test_split_plan_covers_live_pages_once(name):
    slots, rows, nlog, bs, positions = PLANS[name]
    cp = k4_split_plan(slots, rows, nlog, bs, SMS)
    assert cp >= 1 and cp & (cp - 1) == 0
    assert cp * bs >= min(ref.K4_STAGE_KEYS, nlog * bs)
    n_chunks = math.ceil(nlog / cp)
    assert n_chunks <= ref.K4_MAX_CHUNKS
    # the grid covers the card unless the chunk is at its least or the cap
    # on chunks set it
    tiles = math.ceil(rows / ref.K4_TILE_ROWS)
    least = cp == 1 or (cp // 2) * bs < ref.K4_STAGE_KEYS
    capped = math.ceil(nlog / (cp // 2 or 1)) > ref.K4_MAX_CHUNKS
    assert slots * tiles * n_chunks >= SMS or least or capped
    rng = np.random.default_rng(len(name))
    for prow in positions:
        lo, hi = k2_span(prow, nlog, bs)
        chunks = k2_chunks(lo, hi, cp)
        pages = [p for a, b in chunks for p in range(a, b)]
        assert lo == 0 and pages == list(range(lo, hi))      # each once, in order
        assert all(b - a <= cp for a, b in chunks)
        # no key outside the span is valid for any row of the slot
        kpos = np.arange(nlog * bs)
        valid = np.zeros(nlog * bs, bool)
        for qp in prow:
            valid |= kpos <= qp
        assert not valid[hi * bs:].any()
        # a table with sentinel tails and a hole: the pages loaded are the
        # live pages of the span, each once, never a sentinel
        table = rng.permutation(nlog * 4)[:nlog].astype(np.int32)
        table[rng.integers(0, nlog)] = -1
        table[max(hi - 1, 0):] = nlog * 4
        live = [p for a, b in chunks for p in range(a, b) if 0 <= table[p] < nlog * 4]
        assert len(live) == len(set(live))
        assert sorted(live) == [p for p in range(lo, hi) if 0 <= table[p] < nlog * 4]


def test_serve_shape_reads_each_page_once_per_slot():
    """minicpm3-4b's serve decode (8 slots, 40 rows, 34 pages of 16): one
    head tile, chunks of two pages, so launch 1 loads each live latent page
    once per slot (the whole-row design re-read it in 20 CTAs)."""
    slots, rows, nlog, bs, positions = PLANS["serve decode"]
    assert math.ceil(rows / ref.K4_TILE_ROWS) == 1
    cp = k4_split_plan(slots, rows, nlog, bs, SMS)
    assert cp == 2
    for prow in positions:
        loads = [p for a, b in k2_chunks(*k2_span(prow, nlog, bs), cp) for p in range(a, b)]
        assert sorted(loads) == list(range(k2_span(prow, nlog, bs)[1]))


def _faulty(attr, fn, c, cp):
    saved = getattr(ref, attr)
    setattr(ref, attr, fn)
    try:
        return _run(c, cp)
    finally:
        setattr(ref, attr, saved)


def test_per_chunk_max_fault_changes_probabilities():
    """Quantizing each chunk against its own max (chip_smoke.py's first K4
    fault) is not Alg. 1: the bitwise check sees it."""
    c = _case("decode")
    _, _, pr_w = _run(c, None)
    _, _, pr = _faulty("split_row_max", lambda m: m, c, 1)
    assert not torch.equal(pr, pr_w)


def test_dropped_partial_fault_breaks_tree_bound():
    """A dropped chunk partial (chip_smoke.py's second K4 fault) is far
    outside the summation tree's bound."""
    c = _case("decode")
    original = ref.combine_partials

    def dropped(partials):
        return original(partials[:-1]) if len(partials) > 1 else torch.zeros_like(partials[0])

    out, _, pr = _faulty("combine_partials", dropped, c, 1)
    exact, bound = _tree(c, pr, 1)
    o = out.double()
    excess = (o - exact).abs() - 0.5 * _ulp(torch.maximum(o.abs(), exact.abs()))
    assert float((excess / bound.clamp_min(1e-300)).max()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_k4_kernel_matches_plain_split_on_card(scenario, dtype):
    """The CUDA kernel against its plain split version at the kernel's own
    chunk size: the plain Alg. 1 on the kernel's scores gives its
    probabilities bitwise, a second run gives the same bits, and its
    outputs are within the two sides' summation bounds and probability
    differences times |c| of the plain split version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref
    from repro_torch.kernels.paged_attention import ops

    c = _case(scenario)
    args = tuple(x.to("cuda") if torch.is_tensor(x) else x for x in c["args"])
    args = tuple(x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
                 for x in args)
    b, rows, _ = args[0].shape
    L = c["nlog"] * c["bs"]

    def run():
        sc = torch.zeros((b, rows, L), device="cuda")
        pr = torch.zeros_like(sc)
        return ops.paged_attention_mla_rows(*args, scale=c["scale"], scores_out=sc,
                                            probs_out=pr), sc, pr

    out, sc, pr = run()
    assert all(torch.equal(x, y) for x, y in zip((out, sc, pr), run()))
    valid = torch.from_numpy(c["valid"]).to("cuda")
    again = int_softmax_ref(sc.reshape(-1, L), BEST, valid.reshape(-1, L)).reshape(sc.shape)
    assert torch.equal(again, pr)
    cp = k4_split_plan(b, rows, c["nlog"], c["bs"],
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       args[5].shape[1])
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want, _, want_pr = paged_attention_mla_ref(*args, scale=c["scale"], chunk_pages=cp,
                                                   return_rows=True)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    lat = paged_gather(args[2], args[4]).double().abs()
    p, wp = pr.to(dtype).double(), want_pr.to(dtype).double()
    dp = torch.einsum("srl,slk->srk", (p - wp).abs(), lat)
    # inside a chunk of nk keys each side's sum is within nk u sum |p c| (any
    # order, or the kernel's key-order fmaf) or 32 2^-23 per 16-key tensor-
    # core step (tests/test_torch_mla_kernel.py:MMA_U) of the chunk's sum |p
    # c|; each chunk-order add after the first rounds once
    nk = cp * c["bs"]
    mass = torch.einsum("srl,slk->srk", p + wp, lat)
    n_chunks = math.ceil(c["nlog"] / cp)
    tol = (max(nk * U, 32 * 2.0 ** -23 * (1 + 2.0 ** -8) * math.ceil(nk / 16)) * mass
           + n_chunks * U * mass + dp)
    mant = 7 if dtype == torch.bfloat16 else 23
    o, w = out.double(), want.double()
    tol = tol + torch.exp2(torch.floor(torch.log2(torch.maximum(o.abs(), w.abs())
                                                  .clamp_min(2.0 ** -126))) - mant)
    assert bool(((o - w).abs() <= tol).all())
