"""K2's split over CTAs, checked on the CPU through its plain split version.

The CUDA kernel (``csrc/paged_attention.cu``) cuts each row's live pages
into chunks (``ref.k2_split_plan`` / ``k2_chunks``) and runs Alg. 1 in exact
passes: per-chunk maxima combined into the row max, per-chunk integer sums,
per-chunk f32 PV partials added in chunk order. ``paged_attention_ref(...,
chunk_pages=p)`` mirrors that partition; these tests hold it:

* its probabilities bitwise equal to the whole-row plain version's (which
  runs the reference's Alg. 1), and its outputs within the two-level f32
  bound of its summation tree of the exact f64 sum and of the JAX
  ``paged_attend_dense`` run in interpret mode (as ``tests/test_torch_paged.py``
  runs it), over chunks of 1 page, 3 pages and the whole span;
* the identity the kernel's second pass rests on: the integer row max is the
  code of the fp row max, 0 for any row with a valid key;
* the plan: every page of the span in exactly one chunk, in order, no
  sentinel page loaded, nothing outside the span needed by any row;
* the two faults ``chip_smoke.py --fault-control`` patches in are seen by
  these checks.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.precision import BEST as JBEST
from repro.kernels.paged_attention import ops as jops
from repro_torch.core.alg1 import int_softmax_block
from repro_torch.core.precision import BEST
from repro_torch.core.quantization import NEG_INF, quantize_against, quantize_stable_scores
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.ref import (
    k2_chunks, k2_span, k2_split_plan, paged_attention_ref,
)
from repro_torch.models.attention import kv_dequantize, paged_gather

torch.set_num_threads(2)

U = 2.0 ** -24 * (1 + 2.0 ** -8)          # f32 unit roundoff, with room for its own rounding

# scenario -> (B, T, H, KV, BS, NLOG, window, int8, parked slot, all-masked slot)
SCENARIOS = {
    "decode": (3, 1, 4, 2, 8, 6, 0, False, None, None),
    "window": (3, 1, 4, 2, 8, 6, 12, False, None, None),
    "sentinel tails": (4, 1, 2, 2, 4, 9, 0, False, None, None),
    "parked slot": (3, 1, 4, 2, 8, 6, 0, False, 1, None),
    "all-masked row": (3, 1, 4, 2, 8, 6, 0, False, None, 2),
    "T 3": (3, 3, 4, 2, 8, 6, 0, False, None, None),
    "GQA 4": (3, 1, 8, 2, 8, 6, 0, False, None, None),
    "int8 pools": (3, 1, 4, 2, 8, 6, 0, True, None, None),
}
CHUNKS = {"1 page": 1, "3 pages": 3, "whole span": None}   # None: NLOG pages


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy inputs of a scenario, the reference's bf16 output (JAX
    interpret mode) and the torch tensors in the kernel's layout. Head dim
    32 as in tests/test_torch_paged.py: there XLA's and torch's bf16 scores
    agree, so the whole-row outputs are bitwise equal (at 16 some score
    rounds apart, a tier-(b) difference that can move an Alg.-1 code)."""
    b, t, h, kvh, bs, nlog, window, int8, parked, masked = SCENARIOS[name]
    d = 32
    nb = b * nlog + 2
    r = np.random.default_rng(sorted(SCENARIOS).index(name))
    q = r.normal(size=(b, t, h, d)).astype(np.float32)
    if int8:
        k = r.integers(-127, 128, (nb, bs, kvh, d)).astype(np.int8)
        v = r.integers(-127, 128, (nb, bs, kvh, d)).astype(np.int8)
        ks = (r.random((nb, bs, kvh)) * .1).astype(np.float32)
        vs = (r.random((nb, bs, kvh)) * .1).astype(np.float32)
    else:
        k = r.normal(size=(nb, bs, kvh, d)).astype(np.float32)
        v = r.normal(size=(nb, bs, kvh, d)).astype(np.float32)
        ks = vs = None
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
    jq = jnp.asarray(q, jnp.bfloat16)
    jk, jv = (jnp.asarray(x) if int8 else jnp.asarray(x, jnp.bfloat16) for x in (k, v))
    extra = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if int8 else {}
    want = jops.paged_attend_dense(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos), JBEST,
                                   scale=d ** -0.5, window=window, interpret=True, **extra)
    want = np.array(jnp.asarray(want, jnp.float32))             # [B, T, H, D]
    group = h // kvh
    tq = torch.from_numpy(q).to(torch.bfloat16).reshape(b, t, kvh, group, d)
    tq = tq.permute(0, 2, 1, 3, 4).reshape(b, kvh, t * group, d).contiguous()
    if int8:
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        kw = {}
    want = torch.from_numpy(want).reshape(b, t, kvh, group, d).permute(0, 2, 1, 3, 4)
    want = want.reshape(b, kvh, t * group, d).double()
    return dict(q=tq, k=tk, v=tv, table=torch.from_numpy(table), pos=torch.from_numpy(pos),
                kw=dict(scale=d ** -0.5, window=window, **kw), want=want, nlog=nlog, bs=bs)


def _run(c, chunk_pages):
    return paged_attention_ref(c["q"], c["k"], c["v"], c["table"], c["pos"], BEST,
                               chunk_pages=chunk_pages, return_rows=True, **c["kw"])


def _tree(c, probs, cp):
    """The exact f64 sum over the bf16 probabilities and the two-level f32
    bound of the split's summation tree: any order of the n keys inside a
    chunk (n u sum |p v|), then the partials added in chunk order from 0
    (u |partials added so far| after the first). [S, KV, ROWS, Dv] each."""
    v = paged_gather(c["v"], c["table"])
    if "v_scale" in c["kw"]:
        v = kv_dequantize(v, paged_gather(c["kw"]["v_scale"], c["table"]), torch.bfloat16)
    v = v.double()                                           # [S, L, KV, Dv]
    p = probs.to(torch.bfloat16).double()                    # [S, KV, ROWS, L]
    exact = torch.zeros(p.shape[:3] + (v.shape[-1],), dtype=torch.float64)
    bound = torch.zeros_like(exact)
    nlog, bs = c["nlog"], c["bs"]
    for s, prow in enumerate(c["pos"].tolist()):
        for i, (a, b) in enumerate(k2_chunks(*k2_span(prow, nlog, bs, c["kw"]["window"]), cp)):
            terms = torch.einsum("krl,lkd->krld", p[s, :, :, a * bs:b * bs],
                                 v[s, a * bs:b * bs])
            bound[s] += (b - a) * bs * U * terms.abs().sum(2)
            exact[s] += terms.sum(2)
            if i:
                bound[s] += U * exact[s].abs()
    return exact, bound


def _half_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 8)


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_split_probs_bitwise_outputs_within_tree_bound(scenario, chunk):
    c = _case(scenario)
    cp = CHUNKS[chunk] or c["nlog"]
    out_w, sc_w, pr_w = _run(c, None)
    out, sc, pr = _run(c, cp)
    assert torch.equal(sc, sc_w)
    assert torch.equal(pr, pr_w), "split probabilities differ from the whole row's"
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    exact, bound = _tree(c, pr, cp)
    o = out.double()
    assert bool(((o - exact).abs() <= bound + _half_ulp(torch.maximum(o.abs(), exact.abs()))).all())
    # the JAX kernel: the whole-row plain version's output is its own bit
    # for bit, so the split's probabilities are the ones it normalized; the
    # outputs differ by the two f32 sums (its own: n u sum |p v| over the n
    # keys of the row) and the two bf16 roundings
    want = c["want"]
    assert torch.equal(out_w.double(), want)
    mass = bound.new_zeros(bound.shape)
    v_abs = paged_gather(c["v"], c["table"]).double().abs()
    if "v_scale" in c["kw"]:
        v_abs = (kv_dequantize(paged_gather(c["v"], c["table"]),
                               paged_gather(c["kw"]["v_scale"], c["table"]),
                               torch.bfloat16).double().abs())
    mass += torch.einsum("skrl,slkd->skrd", pr.to(torch.bfloat16).double(), v_abs)
    n = c["nlog"] * c["bs"]
    tol = bound + n * U * mass + 2 * _half_ulp(torch.maximum(o.abs(), want.abs()))
    assert bool(((o - want).abs() <= tol).all())
    if scenario == "all-masked row":
        assert float(pr[2].abs().max()) == 0.0 and float(out[2].abs().max()) == 0.0


ROWS = {
    "random": ([0.3, -1.2, 2.5, 0.0, -7.0, 2.4], [1, 1, 1, 1, 1, 1]),
    "one valid": ([0.3, -1.2, 2.5, 9.0], [0, 0, 1, 0]),
    "ties at the max": ([1.5, 1.5, -0.5, 1.5], [1, 1, 1, 1]),
    "beyond the clip": ([-40.0, 10.0, -1e20, 9.999], [1, 1, 1, 1]),
    "masked max": ([5.0, -3.0, -2.0, 100.0], [1, 1, 1, 0]),
    "all masked": ([0.5, -0.25, 3.0], [0, 0, 0]),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_integer_row_max_is_code_of_row_max(row):
    """The kernel's second pass takes the integer max as the code of the fp
    row max, quantize(m, m) = 0, instead of a pass over the codes: it equals
    the max over the valid codes (quantize is monotone), and for a fully
    masked row (m guarded to 0) every code is masked out anyway."""
    x = torch.tensor(ROWS[row][0], dtype=torch.float32)
    mask = torch.tensor(ROWS[row][1], dtype=torch.bool)
    m = torch.where(mask, x, NEG_INF).amax()
    mu = torch.where(m <= NEG_INF, 0.0, m)
    vmax = quantize_against(m, mu, BEST)
    codes = quantize_stable_scores(x, BEST, mask=mask)
    if mask.any():
        assert int(vmax) == 0 == int(codes[mask].max())
    else:
        assert not bool(mask.any())
        p = int_softmax_block(x[None], mask[None], BEST)
        assert float(p.abs().max()) == 0.0


PLANS = {
    "serve decode": (8, 16, 1, 36, 16, 0, [[400], [575], [433]]),
    "32768-token row": (1, 16, 1, 2048, 16, 0, [[32767]]),
    "rows 35": (1, 4, 35, 2048, 16, 0, [[32763, 32764, 32765, 32766, 32767]]),
    "window": (4, 8, 4, 64, 16, 100, [[1000], [99], [5], [1023]]),
    "block size 8": (3, 2, 1, 40, 8, 0, [[0], [319], [160]]),
    "block size 64": (3, 2, 2, 9, 64, 0, [[575], [64], [63]]),
    "parked and empty": (3, 2, 1, 6, 16, 0, [[96], [-1], [40]]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_split_plan_covers_live_pages_once(name):
    slots, kv, rows, nlog, bs, window, positions = PLANS[name]
    cp = k2_split_plan(slots, kv, rows, nlog, bs, 132)
    assert cp >= 1 and cp & (cp - 1) == 0
    assert cp * bs >= min(64, nlog * bs) or 4 * rows * 2 * cp * bs > ref.K2_TILE_BYTES
    assert cp == 1 or 4 * rows * cp * bs <= ref.K2_TILE_BYTES
    rng = np.random.default_rng(len(name))
    for prow in positions:
        lo, hi = k2_span(prow, nlog, bs, window)
        chunks = k2_chunks(lo, hi, cp)
        pages = [p for a, b in chunks for p in range(a, b)]
        assert pages == list(range(lo, hi))                  # each once, in order
        assert all(b - a <= cp for a, b in chunks)
        # no key outside the span is valid for any row of the slot
        kpos = np.arange(nlog * bs)
        valid = np.zeros(nlog * bs, bool)
        for qp in prow:
            valid |= (kpos <= qp) & ((kpos > qp - window) if window else True)
        assert not valid[:lo * bs].any() and not valid[hi * bs:].any()
        # a table with sentinel tails and a hole: the pages loaded are the
        # live pages of the span, each once, never a sentinel
        table = rng.permutation(nlog * 4)[:nlog].astype(np.int32)
        table[rng.integers(0, nlog)] = -1
        table[max(hi - 1, 0):] = nlog * 4
        live = [p for a, b in chunks for p in range(a, b) if 0 <= table[p] < nlog * 4]
        assert len(live) == len(set(live))
        assert sorted(live) == [p for p in range(lo, hi) if 0 <= table[p] < nlog * 4]


def _faulty(attr, fn, c, cp):
    saved = getattr(ref, attr)
    setattr(ref, attr, fn)
    try:
        return _run(c, cp)
    finally:
        setattr(ref, attr, saved)


def test_per_chunk_max_fault_changes_probabilities():
    """Quantizing each chunk against its own max (chip_smoke.py's first
    K2 fault) is not Alg. 1: the bitwise check sees it."""
    c = _case("decode")
    _, _, pr_w = _run(c, None)
    _, _, pr = _faulty("split_row_max", lambda m: m, c, 1)
    assert not torch.equal(pr, pr_w)


def test_dropped_partial_fault_breaks_tree_bound():
    """A dropped chunk partial (chip_smoke.py's second K2 fault) is far
    outside the summation tree's bound."""
    c = _case("decode")

    original = ref.combine_partials

    def dropped(partials):
        return original(partials[:-1]) if len(partials) > 1 else torch.zeros_like(partials[0])

    out, _, pr = _faulty("combine_partials", dropped, c, 1)
    exact, bound = _tree(c, pr, 1)
    o = out.double()
    excess = ((o - exact).abs() - _half_ulp(torch.maximum(o.abs(), exact.abs())))
    excess = excess / bound.clamp_min(1e-300)
    assert float(excess.max()) > 100
