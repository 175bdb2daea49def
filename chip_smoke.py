"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: every CUDA kernel of the main path, from ``src/repro_torch/kernels/csrc``;
3. K1 (the Alg.-1 softmax kernel) against its plain PyTorch version, bitwise,
   at the generate and both serve paths' shapes and at edge shapes (odd
   widths, sentinel rows, a saturating sum, M=15 (no exp table), rows split
   over a cluster of CTAs up to 131072 columns, where the plain split
   version over the kernel's chunks must agree too), with the kernel's and
   the plain version's times, the card's memory bound, the launch's layout
   and the CUDA launches of one call (torch.profiler: one of that layout);
4. the main path: full-width olmo-1b (16 layers, d_model 2048, seeded random
   bf16 weights) through ``Engine.generate(mode="fused")`` with softmax
   ``int_pallas``, batch 4, prompt 512, 32 new tokens. K1 must launch exactly
   16 x 32 = 512 times, and the same model with the plain torch Alg. 1
   (``int``) must give bitwise equal tokens and last logits; then the smoke
   config on the card against the same weights on the CPU;
5. K2 (the fused paged decode, each row split over CTAs) against its plain
   PyTorch version at the serve path's decode shape, the reference's
   paged-kernel matrix and long rows (32768 keys; T 5, GQA 7 and 35 rows
   at 16384-32768): the plain Alg. 1 on K2's own scores gives its
   probabilities bitwise; a second run gives the same bits; scores and
   outputs within stated bounds (outputs: of K2's chunked summation tree);
   times and bounds as for K1;
6. the serve path: full-width olmo-1b through ``Engine.serve`` (paged pool,
   prefix sharing, ``kernel="pallas"``) on a 32-request shared-prefix
   trace. K2 must launch 16 x steps times and K1 16 x 32; greedy tokens
   equal ``kernel="jnp"`` and per-request eager but at near ties; every
   served logit within a stated limit of a teacher-forced prefill of the
   served tokens, and of the jnp serve's step by step; warm timings of both
   kernels;
7. K4 (the absorbed-MLA paged decode, each row split over CTAs, both dots
   and PV on tensor cores in bf16) against its plain PyTorch version at the
   MLA serve path's decode shape, the reference's MLA kernel matrix,
   4096-token rows, parked slots, f32 compute, deepseek-v2's width at 512
   and 4096 keys, T 3 at 4096 keys and a 32768-token row, with the checks
   of phase 5 (outputs: of K4's chunked summation tree, bounded for
   truncating tensor-core sums) and a second run bitwise equal (and K1 at
   the MLA path's shapes in phase 3);
8. the MLA serve path: full-width minicpm3-4b (62 layers, d_model 2560, 40
   heads, latent rank 256) through ``Engine.serve`` as in phase 6 on an
   8-request shared-prefix trace: K4 must launch 62 x steps times, K1 62 x
   8 and K2 never; the checks of phase 6 and one warm timing per kernel;
9. K2's int8 branch against its plain version: the serve decode shape with
   absmax and with power-of-two (exaq) scales, sentinels and parked slots,
   4096-token rows, f32 compute, a 32768-token row; phase 5's checks;
10. ``kv_quantize`` on the card against the CPU on the K/V of a full-width
    512-token prefill: absmax bitwise; the EXAQ schemes bitwise or one
    power of two apart (printed);
11. the serve path of phase 6 from an int8 KV pool (absmax): K2 must launch
    16 x steps times, all on int8 pools, and K1 16 x 32; the checks of
    phase 6 with the int8 limits (the teacher-forced pass quantizes K/V as
    the prefill does), the pool's bytes per token, and for information the
    logit distance to the bf16 model;
12. K3 (the stand-alone fused prefill attention: query tiles over key tiles
    in three exact Alg.-1 passes, bf16 products on tensor cores) against its
    plain version: first its branch-free division by S against IEEE
    division over every f32 it may divide (three configs); then the
    reference's kernel matrix, the full widths (olmo-1b's prefill, a
    4096-token prefill, GQA 32/8 at 2048) and the tiles' edges (a 128-token
    tail on 512 keys, ragged Sq 1000, a window of 1024, d 64, d 256, d 24
    at M=15, rows that see no key, 64 queries on 65536 keys, which the
    whole-row design refused): the plain Alg. 1 on its own scores bitwise,
    a second run bitwise equal, one CUDA launch a call (torch.profiler),
    score writes exactly at ``ref.k3_plan``'s key tiles, its shared memory
    ``ref.k3_smem_bytes``; scores within their summation bounds (bf16: of
    tensor-core sums) and in bf16 at most 1 % beyond a quarter of a bf16
    ulp of the exactly rounded dot; outputs within the bound of the
    kernel's key-order sum (bf16: 16 keys a tensor-core step) and of the
    plain version's; then ``int_attention`` as a user calls it, launching
    K3 once;
13. chunked prefill and priority preemption: phase 6's trace with every
    fourth request in class 0 and the rest in class 1, served with phase
    6's options plus ``prefill_chunk=128`` and ``preemption=True`` from a
    pool of six requests' worst case, once from the bf16 pool and once
    from the int8 pool, each against phase 6's plain serve of the same
    trace from the same pool. Gates: preemptions >= 1 and as many resumes,
    no leaked blocks, at most 128 prompt tokens a step (beyond a resume's
    re-prefill of evicted blocks), cost shares summing to the batch meter,
    K2 16 x steps launches (on int8 pools only in the int8 run), K1 16 x
    the prefill pieces worked out from the trace, greedy tokens equal to
    the plain serve's but at near ties, served logits within phase 6's
    limits of a teacher-forced pass and, step by step, of the plain
    serve's. Beside them: the swap round trip on each full-width pool
    (bitwise), a 2048-token prompt prefilled whole and in 256-token chunks
    and a 512-token one in 128-token chunks (equal K/V bytes, printed),
    and from the bf16 pool the chunked and
    plain serves' ms per step, most prompt tokens in a step and time
    between tokens (p50, p99, max), with the card's name and power limit;
14. a ``kernels`` JSON line per ported kernel (K2's int8 branch its own
    entry), the card line, and the result line ``{"ok": true, "device":
    {...}}`` last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.

    python3 chip_smoke.py --fault-control

reads phase 3's K1 check against two faults of K1's split patched into
its plain split version (each chunk quantizing against its own max, a
dropped chunk sum), phase 5's K2 checks and phase 7's K4 checks against
two faults of each split (each chunk quantizing against its own max, a
dropped chunk partial), phase 12's K3 checks against three faults of its
plain tiled version (each key tile quantizing against its own max, a
dropped key tile's PV, scores rounded to bf16), then the MLA serve path's
end-to-end checks (phase 8's logit limits and near-tie rule) against known
faults patched into its gather decode, then phase 13's checks (the swap
round trip, the logit and token checks on phase 13's trace and on a
targeted trace whose victim holds several private blocks) against two
faults patched into ``kv_cache`` (``swap_write`` restoring the private
blocks in reversed order, a chunk committing one position late), and
prints which checks catch each.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))

# Data-sheet HBM rates (bytes/s) by card name, most specific first.
HBM_RATE = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12)]
# Outside the tensor cores the guide's table gives 67 TFLOP/s (f32). K1's
# int32 work is counted at that rate: the int32 rate is no higher, so this
# under-states the operation bound, which stays far below the memory bound.
ALU_RATE = 67e12
K1_OPS_PER_ELEMENT = 40   # quantize ~6, exp ~16, sum 1, divide + dequant ~17
# The dots and the PV of K2 and K4 multiply compute-dtype operands and
# accumulate in f32: tensor-core work for bf16 (the TPU kernels run them on
# the MXU), counted at the H100's dense bf16 peak from the guide's table;
# f32 operands are counted outside the tensor cores (no TF32).
MMA_RATE = {torch.bfloat16: 989e12, torch.float32: ALU_RATE}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise SystemExit(f"FAILED: no data-sheet memory rate for card {name!r}")


def ops_ms(mma_flops, dtype, alu_ops) -> float:
    """Least time of the operations: the products at their operand type's
    peak and Alg. 1 at ALU_RATE, on separate units, so the larger."""
    return max(mma_flops / MMA_RATE[dtype], alu_ops / ALU_RATE) * 1e3


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(fn, reps: int) -> float:
    """Median time of one eager call, CUDA events around it: includes the
    host's launch work whenever the device waits for it."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(fn) for _ in range(reps))


def device_ms(fn, per_graph: int = 10, reps: int = 5) -> float:
    """Device time of one call: ``per_graph`` calls captured in one CUDA
    graph, median over ``reps`` replays, divided by ``per_graph`` — the
    host's launch overhead drops out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(g.replay) for _ in range(reps)) / per_graph


# ----------------------------------------------------------------- phase 3


def k1_layout(plan, rows) -> str:
    if plan.layout == "rows":
        return (f"rows layout: a warp a row, {plan.rows_per_cta} a CTA, "
                f"{plan.per_thread} a lane ({-(-rows // plan.rows_per_cta)} CTAs)")
    return (f"split layout: a cluster of {plan.cluster} CTAs a row, chunks of "
            f"{plan.chunk_cols} columns, {plan.per_thread} a thread "
            f"({rows * plan.cluster} CTAs)")


# Quiet time (s) before and after the calls of one launch-check session, in
# turn: a session that loses a kernel is run again with the next. On the
# H100 machine torch.profiler's device trace drops a kernel as out of its
# session's window (Kineto: "Out-of-range"), more often the longer the
# process has run: a few seconds into a process every kernel of a short
# session came back, a minute later most were lost, while sessions with 2 s
# before and after kept every one.
LAUNCH_CHECK_PADS = (0.0, 1.0, 4.0, 16.0)


def launch_checks(kind, calls):
    """Run each of ``calls`` (``(label, fn, kernel, rec)``) once under one
    torch.profiler session, each inside ``record_function(label)``, and
    check that it made one CUDA kernel launch (the runtime's launch calls,
    host side, within the label's range) and that the device trace holds
    one kernel for it whose name contains ``kernel`` (matched to its launch
    call by CUPTI's correlation id, not by time). Writes the counts and
    names into ``rec``. A session in which some label made its one launch
    but the trace lost the kernel is run again with the next quiet time of
    ``LAUNCH_CHECK_PADS``; a kernel still missing after the last fails, as
    does any other count or name at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = [label for label, *_ in calls]
    check(len(set(labels)) == len(labels), f"{kind}: launch-check labels repeat")
    for pad in LAUNCH_CHECK_PADS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for label, fn, _, _ in calls:
                with record_function(label):
                    fn()
                torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.profiler.kineto_results.events()
        ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU and e.name() in labels]
        check(len(ranges) == len(labels), f"{kind}: the profiler recorded "
              f"{len(ranges)} of {len(labels)} launch-check ranges")
        launches = {label: [] for label in labels}
        kernels = {label: [] for label in labels}
        caller = {}  # a launch call's correlation id -> its label
        for e in events:
            if e.device_type() == DeviceType.CPU and "LaunchKernel" in e.name():
                owner = [label for t0, t1, label in ranges if t0 <= e.start_ns() <= t1]
                check(len(owner) == 1,
                      f"{kind}: a launch call outside the checked calls: {e.name()}")
                launches[owner[0]].append(e.name())
                caller[e.correlation_id()] = owner[0]
        for e in events:  # kernels (the labels' device-side ranges aside)
            if e.device_type() == DeviceType.CUDA and e.name() not in labels:
                check(e.correlation_id() in caller,
                      f"{kind}: a kernel no checked call launched: {e.name()}")
                kernels[caller[e.correlation_id()]].append(e.name())
        for label, _, kernel, rec in calls:
            check(len(launches[label]) == 1,
                  f"{kind} {label}: one call made the CUDA launches {launches[label]}")
            check(len(kernels[label]) <= 1 and all(kernel in n for n in kernels[label]),
                  f"{kind} {label}: one call launched the kernels {kernels[label]}, "
                  f"not one {kernel}")
        lost = [label for label in labels if not kernels[label]]
        if not lost:
            break
    check(not lost, f"{kind}: the device trace lost the kernels of {lost} "
          f"with {LAUNCH_CHECK_PADS[-1]} s before and after the calls")
    for label, _, kernel, rec in calls:
        rec["cuda_launches_per_call"] = len(launches[label])
        rec["kernels_traced"] = kernels[label]
    print(f"{kind}: each of {len(calls)} calls made one CUDA launch, and the device "
          f"trace holds its kernel ({', '.join(sorted({k for _, _, k, _ in calls}))}; "
          f"torch.profiler, {pad} s before and after the calls)", flush=True)


def k1_case(label, x, mask, cfg, rate, launch_calls, reps=20):
    """Kernel vs plain version on one input, bitwise (and, for the split
    layout, the plain split version over the kernel's chunks); returns its
    record and adds its call to ``launch_calls`` (for ``launch_checks``)."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref, int_softmax_split_ref

    plan = ops.launch_plan(x)
    before = ops.int_softmax_rows.launches
    got = ops.int_softmax_rows(x, cfg, mask)
    check(ops.int_softmax_rows.launches == before + 1, f"K1 {label}: wrapper did not launch")
    want = int_softmax_ref(x, cfg, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K1 {label}: kernel != plain (max abs err {err})")
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
    if plan.layout == "split":
        split = int_softmax_split_ref(x, cfg, mask, plan.chunk_cols)
        check(torch.equal(split, want), f"K1 {label}: plain split != plain whole rows")
    rows, cols = x.shape
    nbytes = rows * cols * (4 + 4 + (1 if mask is not None else 0))
    bytes_ms = nbytes / rate * 1e3
    op_ms = ops_ms(0, torch.float32, rows * cols * K1_OPS_PER_ELEMENT)
    kernel = lambda: ops.int_softmax_rows(x, cfg, mask)  # noqa: E731
    plain = lambda: int_softmax_ref(x, cfg, mask)  # noqa: E731
    rec = {"shape": label, "rows": rows, "cols": cols, "masked": mask is not None,
           "M": cfg.M, "max_abs_err": err, "layout": plan.layout,
           "per_thread": plan.per_thread, "rows_per_cta": plan.rows_per_cta,
           "cluster": plan.cluster, "chunk_cols": plan.chunk_cols,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, reps), "plain_call_ms": call_ms(plain, reps),
           "bound_ms": max(bytes_ms, op_ms),
           "bound_by": "bytes" if bytes_ms >= op_ms else "operations"}
    print(f"K1 {label:<32} [{rows}, {cols}] M={cfg.M} mask={mask is not None}: "
          f"bitwise equal; device ms: kernel {rec['ms']:.4f}, plain "
          f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f} ({rec['bound_by']}, "
          f"{rec['bound_ms'] / rec['ms'] * 100:.1f}% of it); per eager call: kernel "
          f"{rec['call_ms']:.4f}, plain {rec['plain_call_ms']:.4f}; {k1_layout(plan, rows)}",
          flush=True)
    launch_calls.append((f"K1 {label}", kernel, f"k1_{plan.layout}", rec))
    return rec


def phase3_k1(rate):
    from repro_torch.core.precision import BEST, PrecisionConfig

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def scores(rows, cols):
        return torch.randn((rows, cols), generator=gen, device=dev) * 3.0

    recs, calls = [], []
    # main path, decode: [batch 4 x heads 16, cache 544], valid_upto at the
    # first decode position (513 valid, 31 not yet written)
    kv = torch.arange(544, device=dev)
    m = (kv <= 512).expand(64, 544).to(torch.uint8).contiguous()
    recs.append(k1_case("decode (main path)", scores(64, 544), m, BEST, rate, calls))
    # main path, prefill: [4 x 16 x 512 query rows, 512], causal
    causal = torch.tril(torch.ones(512, 512, dtype=torch.uint8, device=dev))
    m = causal.repeat(64, 1)
    recs.append(k1_case("prefill (main path)", scores(64 * 512, 512), m, BEST, rate, calls))
    # edges
    recs.append(k1_case("cols 1", scores(64, 1), None, BEST, rate, calls))
    m = (torch.rand((64, 1), generator=gen, device=dev) < 0.5).to(torch.uint8)
    recs.append(k1_case("cols 1, masked", scores(64, 1), m, BEST, rate, calls))
    recs.append(k1_case("cols 1000", scores(256, 1000), None, BEST, rate, calls))
    m = (torch.rand((8, 32768), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 32768 (max_seq)", scores(8, 32768), m, BEST, rate, calls))
    m = (torch.rand((64, 544), generator=gen, device=dev) < 0.7).to(torch.uint8)
    m[0:8] = 0                       # all-masked rows
    m[8:16] = 0
    m[8:16, 100] = 1                 # lone-element rows: v_approx == total
    recs.append(k1_case("all-masked + lone-element rows", scores(64, 544), m, BEST, rate, calls))
    m4 = PrecisionConfig(M=4, T_C=-4.0)
    recs.append(k1_case("prefill rows, M=4 T_C=-4", scores(16 * 512, 512),
                        causal.repeat(16, 1), m4, rate, calls))
    recs.append(k1_case("lone-element rows, M=4 T_C=-4", scores(64, 544),
                        m, m4, rate, calls))
    # the olmo-1b serve path (phase 6: 16 heads, rows h * T + t): the first
    # request's whole 512-token prefill, then tail prefills of 16, 64 and
    # 128 tokens behind the 384-token shared prefix
    recs.append(k1_case("olmo whole prefill (16 x 512)", scores(16 * 512, 512),
                        causal.repeat(16, 1), BEST, rate, calls))
    for n in (16, 64, 128):
        tail = (torch.arange(384 + n, device=dev)[None, :]
                <= 384 + torch.arange(n, device=dev)[:, None]).to(torch.uint8)
        recs.append(k1_case(f"olmo tail prefill (16 x {n}, 384 + {n})",
                            scores(16 * n, 384 + n), tail.repeat(16, 1), BEST, rate, calls))
    # phase 13's chunks of 128 tokens after 0, 128 and 256 committed (the
    # chunk after 384 is the 128-token tail above)
    for s in (0, 128, 256):
        piece = (torch.arange(s + 128, device=dev)[None, :]
                 <= s + torch.arange(128, device=dev)[:, None]).to(torch.uint8)
        recs.append(k1_case(f"olmo chunk (16 x 128, {s} + 128)", scores(16 * 128, s + 128),
                            piece.repeat(16, 1), BEST, rate, calls))
    # the MLA serve path (phase 8: minicpm3-4b, 40 heads, one request per
    # prefill, rows h * T + t): a whole prefill of a 400-token prompt; a
    # tail prefill of 128 tokens behind the 384-token shared prefix (query
    # t at position 384 + t); the gather decode of kernel="jnp" over 8 slots
    # x 40 heads, cache_len 544, each slot at its own position
    tril = torch.tril(torch.ones(400, 400, dtype=torch.uint8, device=dev))
    recs.append(k1_case("MLA prefill (40 x 400)", scores(40 * 400, 400),
                        tril.repeat(40, 1), BEST, rate, calls))
    tail = (torch.arange(512, device=dev)[None, :]
            <= 384 + torch.arange(128, device=dev)[:, None]).to(torch.uint8)
    recs.append(k1_case("MLA tail prefill (40 x 128, 384 + 128)", scores(40 * 128, 512),
                        tail.repeat(40, 1), BEST, rate, calls))
    # the rest of the MLA serve's prefills: the first request's whole
    # 512-token prefill and the 16- and 64-token tails
    recs.append(k1_case("MLA whole prefill (40 x 512)", scores(40 * 512, 512),
                        causal.repeat(40, 1), BEST, rate, calls))
    for n in (16, 64):
        tail = (torch.arange(384 + n, device=dev)[None, :]
                <= 384 + torch.arange(n, device=dev)[:, None]).to(torch.uint8)
        recs.append(k1_case(f"MLA tail prefill (40 x {n}, 384 + {n})", scores(40 * n, 384 + n),
                            tail.repeat(40, 1), BEST, rate, calls))
    qpos = torch.as_tensor(np.random.default_rng(1).integers(400, 544, size=8), device=dev)
    m = (torch.arange(544, device=dev)[None, :] <= qpos[:, None]).to(torch.uint8)
    recs.append(k1_case("MLA decode, kernel=jnp (8 x 40)", scores(320, 544),
                        m.repeat_interleave(40, dim=0), BEST, rate, calls))
    # odd columns: scalar loads and stores
    m = (torch.rand((64, 543), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 543 (scalar tail)", scores(64, 543), m, BEST, rate, calls))
    m = (torch.rand((8, 1001), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 1001 (scalar tail)", scores(8, 1001), m, BEST, rate, calls))
    # rows whose valid scores all lie at or below the masking sentinel: the
    # guarded max 0 puts them on the floor code (integer max = floor code)
    x = scores(16, 544)
    x[0:8] = -1e30
    x[8:16, ::2] = -2e30
    x[8:16, 1::2] = -1e30
    m = (torch.rand((16, 544), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("valid scores at the sentinel", x, m, BEST, rate, calls))
    # a config whose sum saturates (N = 0: sum_saturation 4095)
    sat = PrecisionConfig(M=6, N=0)
    recs.append(k1_case("saturating sums, N=0", scores(64, 544), None, sat, rate, calls))
    # rows split over a cluster of CTAs
    recs.append(k1_case("cols 32768, one row", scores(1, 32768), None, BEST, rate, calls))
    m = (torch.rand((8, 32768), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 32768 (max_seq), M=4 T_C=-4", scores(8, 32768), m, m4, rate, calls))
    m = (torch.rand((4, 32769), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 32769 (split, scalar tail)", scores(4, 32769), m, BEST, rate, calls))
    m = (torch.rand((4, 131072), generator=gen, device=dev) < 0.7).to(torch.uint8)
    m[0] = 0                         # an all-masked split row
    recs.append(k1_case("cols 131072 (row cap)", scores(4, 131072), m, BEST, rate, calls))
    # M above the exp table's 14 bits: each exp computed, scalar loads
    m15 = PrecisionConfig(M=15, T_C=-1.0, P_out_override=24)
    m = (torch.rand((64, 544), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("M=15 (no exp table)", scores(64, 544), m, m15, rate, calls))
    m = (torch.rand((2, 40001), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("M=15 (no exp table), split", scores(2, 40001), m, m15, rate, calls))
    launch_checks("K1", calls)
    return recs


# ----------------------------------------------------------------- phase 5


# Bounds of K2 against its plain version (tier (b)). The kernel sums the
# D products of a score in f32 in its own order, cuBLAS in another: each sum
# is within D * 2^-24 * sum|q_i k_i| of the exact dot (the f32 summation
# bound), and rounding it to the compute dtype adds at most half an ulp. So
# a score may be one compute-dtype ulp (at the dot's magnitude) plus that
# summation bound from the exactly rounded product, and one ulp plus twice
# it from the plain version's; a score rounded to bf16 after scaling adds
# one bf16 ulp of the score. Near zero the summation bound is many ulps of
# the tiny dot.
# Outputs: the kernel splits each row into chunks of pages (the partition
# of kernels/paged_attention/ref.py:k2_chunks, sized by k2_split_plan).
# Each chunk sums p * v in f32 key by key from 0 (one rounding per fmaf);
# the partials are then added in chunk order from 0 and the total rounded
# once to the compute dtype. So its output is within 2^-24 times the sum,
# over the chunks, of sum_i |in-chunk partial sum i|, plus 2^-24 times
# sum_{c >= 1} |partials 0..c added|, plus half an ulp, of the f64 sum over
# its own compute-dtype probabilities (the PV check; each term with a factor
# 1 + 2^-8 for the rounding of the partial sums it counts). Against the
# plain version's output it may differ by sum_j |p_j - p'_j| |v_j| (the two
# sides' probabilities differ only where a score moved an Alg.-1 code),
# both summation bounds (cuBLAS's, in an order not known here, is n * 2^-24
# * sum |p'| |v| over the n valid keys) and one ulp for the two roundings.
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
# One f32 rounding to nearest (2^-24), with room for the bound's own use of
# computed rather than exact partial sums.
U32 = 2.0 ** -24 * (1 + 2.0 ** -8)
# K4 in bf16 sums on tensor cores (mma.sync m16n8k16, f32 accumulate), whose
# adds are not documented to round to nearest. The bound assumes less: one
# instruction adds its 16 exact bf16 products to the accumulator in fused
# groups of any g <= 16 products, and a group keeps 24 bits of its largest
# addend M (the bits below M's last are cut off each addend: < 2^-23 M
# each) and truncates its result (< 2^-23 |result|), so it loses < 2^-23 (g
# M + |result|). With M and |result| at most X = |partial before the
# instruction| + sum |products of the instruction|, the 16 / g groups lose
# < (16 + 16 / g) 2^-23 X <= 32 2^-23 X: MMA_UNIT per instruction, 16 keys
# (PV) or 16 of the R or DR products (scores). Round-to-nearest is inside
# it; against a key-order f32 sum (n 2^-24 sum |terms| over n terms) it
# allows about 2 to 4 times more at R 256.
MMA_UNIT = 32 * 2.0 ** -23 * (1 + 2.0 ** -8)


def _ulp(x, dtype):
    """The compute-dtype ulp at magnitude |x| (f64)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - MANTISSA[dtype])


def k2_key_chunks(table, pos, *, KV, rows, BS, window):
    """The kernel's chunks per slot as key ranges ``[(first, end), ...]``."""
    from repro_torch.kernels.paged_attention.ref import k2_chunks, k2_span, k2_split_plan

    S, nlog = table.shape
    cp = k2_split_plan(S, KV, rows, nlog, BS,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    spans = [k2_span(p, nlog, BS, window) for p in pos.cpu().tolist()]
    return cp, [[(a * BS, b * BS) for a, b in k2_chunks(lo, hi, cp)] for lo, hi in spans]


def _in_order(terms, mma):
    """terms [ROWS, n, Dv] summed over n in order in f32: one term at a time
    (fmaf, rounded to nearest: U32 per partial sum) or, on tensor cores,
    16 a step (MMA_UNIT per step). Returns the exact f64 sum and the bound
    of the f32 one, [ROWS, Dv] each."""
    if not mma:
        part = torch.cumsum(terms, dim=1)
        return part[:, -1], U32 * part.abs().sum(dim=1)
    steps = F.pad(terms, (0, 0, 0, (-terms.shape[1]) % 16)).unflatten(1, (-1, 16))
    step, mass = steps.sum(2), steps.abs().sum(2)
    before = torch.cumsum(step, 1) - step
    return step.sum(1), MMA_UNIT * (before.abs() + mass).sum(1)


def _mma_dot_bound(q, g):
    """The bound of the f32 dots [S, ROWS, L] of q [S, ROWS, K] and g [S, L,
    K] (f64) summed on tensor cores over K, 16 products a step (MMA_UNIT
    per step; K padded with zeros to a multiple of 16, as the kernel pads
    it)."""
    pad = (-q.shape[-1]) % 16
    q16, g16 = (F.pad(x, (0, pad)).unflatten(-1, (-1, 16)) for x in (q, g))
    step = torch.einsum("srbk,slbk->srlb", q16, g16)
    mass = torch.einsum("srbk,slbk->srlb", q16.abs(), g16.abs())
    before = torch.cumsum(step, -1) - step
    return MMA_UNIT * (before.abs() + mass).sum(-1)


def _pv_sums(probs, vg, dtype, chunks, mma=False):
    """probs [S, KV, ROWS, L] f32, vg [S, L, KV, Dv] f64, ``chunks`` the
    kernel's key ranges per slot -> the exact f64 sum over the
    compute-dtype probabilities and the bound of the kernel's summation
    tree (``_in_order`` inside a chunk, key by key or, ``mma``, 16 keys a
    tensor-core step; then the chunk partials in chunk order, U32 per sum
    after the first), each [S, KV, ROWS, Dv]. One (slot, kv-head, chunk) at
    a time, so long rows fit."""
    S, KV, rows, _ = probs.shape
    exact = torch.zeros((S, KV, rows, vg.shape[-1]), dtype=torch.float64, device=vg.device)
    bound = torch.zeros_like(exact)
    for s in range(S):
        for h in range(KV):
            running = torch.zeros_like(exact[s, h])
            for c, (a, b) in enumerate(chunks[s]):
                terms = (probs[s, h, :, a:b].to(dtype).double()[..., None]
                         * vg[s, a:b, h][None])                   # [ROWS, keys, Dv]
                part, tree = _in_order(terms, mma)
                bound[s, h] += tree
                running += part
                if c:
                    bound[s, h] += U32 * running.abs()
            exact[s, h] = running
    return exact, bound


def _k2_inputs(gen, *, S, KV, group, T, D, BS, NLOG, NB, dtype, qpos,
               parked=(), extra_pages=2):
    """Random q and pools; each slot owns distinct random blocks through the
    page of its last query position plus ``extra_pages`` (capped at NLOG),
    sentinels after them; a parked slot sits at position NLOG * BS with an
    all-sentinel row."""
    dev = torch.device("cuda")
    rows = T * group
    q = torch.randn((S, KV, rows, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((NB, BS, KV, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((NB, BS, KV, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=gen, device=dev).cpu().numpy()
    table = np.full((S, NLOG), NB, np.int32)
    positions = np.zeros((S, T), np.int32)
    used = 0
    for s in range(S):
        if s in parked:
            positions[s] = NLOG * BS
            continue
        positions[s] = qpos[s] + np.arange(T)
        n = min(NLOG, int(positions[s].max()) // BS + 1 + extra_pages)
        table[s, :n] = perm[used:used + n]
        used += n
    assert used <= NB
    return (q, k, v, torch.as_tensor(table, device=dev),
            torch.as_tensor(positions, device=dev))


def k2_checks(x, *, q, k, v, table, pos, kw, group, chunks, want, want_sc, want_pr):
    """K2's checks on one result ``x = (out, scores, probs)``, the kernel's
    or a stand-in's (``--fault-control``), against the plain version's
    ``want``: (a) whether the plain Alg. 1 on its own scores gives its
    probabilities bitwise; (b) its scores in units of their bounds from the
    exactly rounded product and from the plain version's, and its outputs
    in units of the bounds above from the exact sum over its own
    probabilities (the kernel's summation tree over ``chunks``) and from
    the plain version's. Returns them; raises nothing."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref
    from repro_torch.models.attention import kv_dequantize, paged_gather

    out, sc, pr = x
    S, KV, rows, l_full = sc.shape
    D = q.shape[-1]
    dtype, scale = q.dtype, kw["scale"]
    window, scores_dtype = kw["window"], kw["scores_dtype"]
    quant = "k_scale" in kw

    def gathered(pool, scale_pool):                                # [S, L, KV, D] f64
        g = paged_gather(pool, table)
        if quant:
            g = kv_dequantize(g, paged_gather(scale_pool, table), dtype)
        return g.double()

    # (a) the Alg.-1 step, bitwise, on its own scores
    kpos = torch.arange(l_full, device="cuda")
    qp = pos.repeat_interleave(group, dim=1)[:, None, :, None]      # [S,1,ROWS,1]
    valid = kpos <= qp
    if window:
        valid &= kpos > qp - window
    valid = valid.expand(S, KV, rows, l_full).reshape(-1, l_full)
    again = int_softmax_ref(sc.reshape(-1, l_full), BEST, valid).reshape(sc.shape)
    res = {"alg1_bitwise": bool(torch.equal(again, pr))}
    del again
    # (b) bounded: scores against the exactly rounded product (the f64 dot
    # rounded to the compute dtype, then scaled as both sides scale it) and
    # against the plain version, in units of the bound above
    live = valid.reshape(sc.shape)
    kg = gathered(k, kw.get("k_scale"))                            # [S, L, KV, D]
    dot = torch.einsum("skrd,slkd->skrl", q.double(), kg)
    exact = (dot.to(dtype).to(scores_dtype) * scale).float()
    summed = D * 2.0 ** -24 * torch.einsum("skrd,slkd->skrl", q.double().abs(), kg.abs())
    del dot, kg

    def units(y, ref, n_sums):
        mag = torch.maximum(ref.abs(), y.abs()) / scale * (1 + 1e-6)
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - MANTISSA[dtype])
        tol = (ulp + n_sums * summed) * scale
        if scores_dtype == torch.bfloat16:
            tol = tol + torch.exp2(torch.floor(torch.log2(
                torch.maximum(ref.abs(), y.abs()).clamp_min(1e-30))) - 7)
        return float(((y - ref).abs() / (tol * 1.001))[live].max())

    res["score_bound_units"] = {"vs_exact": units(sc, exact, 1),
                                "vs_plain": units(sc, want_sc, 2),
                                "plain_vs_exact": units(want_sc, exact, 1)}
    res["scores_differing"] = int(((sc != want_sc) & live).sum())
    del exact, summed
    # outputs: against the exact sum over its own probabilities (the PV
    # step, the kernel's summation tree) and against the plain version
    vg = gathered(v, kw.get("v_scale"))                            # [S, L, KV, Dv]
    o, w = out.double(), want.double()
    e_k, rec_k = _pv_sums(pr, vg, dtype, chunks)
    vabs = vg.abs()
    mass_p = torch.einsum("skrl,slkd->skrd", want_pr.to(dtype).double().abs(), vabs)
    dp = torch.einsum("skrl,slkd->skrd", (pr.to(dtype).double()
                                          - want_pr.to(dtype).double()).abs(), vabs)
    del vg, vabs
    n_valid = live.sum(-1, keepdim=True).double()
    tol_pv = rec_k + 0.5 * _ulp(torch.maximum(o.abs(), e_k.abs() + rec_k), dtype)
    tol_out = (dp + rec_k + n_valid * 2.0 ** -24 * mass_p
               + _ulp(torch.maximum(o.abs(), w.abs()), dtype))
    res["output_bound_units"] = {"pv_vs_exact": float(((o - e_k).abs() / tol_pv).max()),
                                 "vs_plain": float(((o - w).abs() / tol_out).max())}
    res["finite"] = bool(torch.isfinite(out).all())
    res["max_abs_err"] = float((o - w).abs().max())
    res["out_rms"] = float(w.pow(2).mean().sqrt())
    res["outputs_differing"] = int((out != want).sum())
    return res


def k2_case(label, gen, rate, *, S, KV, group, T=1, D=128, BS=16, NLOG=36,
            NB=None, dtype=torch.bfloat16, window=0, qpos=None, parked=(),
            scores_dtype=torch.float32, quant=None):
    """K2 against its plain version on one input: the checks of ``k2_checks``
    must pass (Alg. 1 on its own scores bitwise, scores and outputs within
    their bounds), and a second run must give the same bits. ``quant``: a
    kv_quantize scheme — the pools become int8 codes with f32 scales, and
    the bounds hold against the dequantized K and V. Returns its record."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.models.attention import kv_quantize

    NB = NB or S * NLOG + 4
    l_full = NLOG * BS
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    if qpos is None:
        qpos = rng.integers(l_full // 2, l_full - T + 1, size=S)
    q, k, v, table, pos = _k2_inputs(gen, S=S, KV=KV, group=group, T=T, D=D, BS=BS,
                                     NLOG=NLOG, NB=NB, dtype=dtype, qpos=qpos,
                                     parked=parked)
    rows = T * group
    kw = dict(scale=D ** -0.5, window=window, scores_dtype=scores_dtype)
    if quant:
        k, ks = kv_quantize(k, quant)
        v, vs = kv_quantize(v, quant)
        kw.update(k_scale=ks, v_scale=vs)

    def run():
        sc = torch.zeros((S, KV, rows, l_full), device="cuda")
        pr = torch.zeros_like(sc)
        out = ops.paged_attention_rows(q, k, v, table, pos, BEST, scores_out=sc,
                                       probs_out=pr, **kw)
        return out, sc, pr

    got = run()
    again = run()
    want, want_sc, want_pr = paged_attention_ref(q, k, v, table, pos, BEST,
                                                 return_rows=True, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 {label}: a second run gave other bits")
    del again
    cp, chunks = k2_key_chunks(table, pos, KV=KV, rows=rows, BS=BS, window=window)
    res = k2_checks(got, q=q, k=k, v=v, table=table, pos=pos, kw=kw, group=group,
                    chunks=chunks, want=want, want_sc=want_sc, want_pr=want_pr)
    worst, out_units = res["score_bound_units"], res["output_bound_units"]
    err, rms = res["max_abs_err"], res["out_rms"]
    check(res["alg1_bitwise"], f"K2 {label}: plain Alg. 1 on the kernel's scores != the "
          "kernel's probabilities")
    check(worst["vs_exact"] <= 1, f"K2 {label}: a score is outside the bound of the "
          f"exactly rounded product ({worst}, in units of the bound)")
    check(worst["vs_plain"] <= 1, f"K2 {label}: a score is outside the bound of the "
          f"plain version's ({worst}, in units of the bound)")
    check(res["finite"], f"K2 {label}: non-finite output")
    check(out_units["pv_vs_exact"] <= 1, f"K2 {label}: an output is outside the bound of "
          f"the exact sum over its own probabilities ({out_units}, in units of the bound)")
    check(out_units["vs_plain"] <= 1, f"K2 {label}: an output is outside the bound of "
          f"the plain version's ({out_units}, in units of the bound; max abs err {err})")
    # bound: the K and V rows the function needs (keys at or below some
    # row's position, inside its window, on a live page; int8 pools: a byte
    # a value and the two f32 scales), q, out, table and positions, each
    # once; operations: the dot and the PV per needed key and row (at the
    # operand type's rate) and Alg. 1 per score
    esz = torch.finfo(dtype).bits // 8
    tab, ps = table.cpu().numpy(), pos.cpu().numpy()
    kp = np.arange(l_full)
    need = kp <= ps[:, :, None]                                    # [S, T, L]
    if window:
        need &= kp > ps[:, :, None] - window
    need &= ((tab >= 0) & (tab < NB))[:, kp // BS][:, None, :]
    keys_read = int(need.any(axis=1).sum())           # a slot's rows share their keys
    row_keys = int(need.sum()) * group
    dv = v.shape[-1]
    kv_bytes = (D + dv + 8) if quant else (D + dv) * esz
    out = got[0]
    nbytes = (keys_read * KV * kv_bytes + (q.numel() + out.numel()) * esz
              + table.numel() * 4 + pos.numel() * 4)
    bytes_ms = nbytes / rate * 1e3
    op_ms = ops_ms(row_keys * KV * (2 * D + 2 * dv), dtype,
                   row_keys * KV * K1_OPS_PER_ELEMENT)
    kernel = lambda: ops.paged_attention_rows(q, k, v, table, pos, BEST, **kw)  # noqa: E731
    plain = lambda: paged_attention_ref(q, k, v, table, pos, BEST, **kw)  # noqa: E731
    n_chunks = sum(len(c) for c in chunks)
    rec = {"shape": label, "S": S, "KV": KV, "rows": rows, "D": D, "BS": BS,
           "NLOG": NLOG, "window": window, "dtype": str(dtype).split(".")[-1],
           "pools": f"int8 ({quant})" if quant else str(dtype).split(".")[-1],
           "scores_dtype": str(scores_dtype).split(".")[-1],
           "keys_read": keys_read, "chunk_pages": cp, "live_ctas": n_chunks * KV,
           "max_abs_err": err, "max_err_over_rms": err / rms, "out_rms": rms,
           "scores_differing": res["scores_differing"],
           "outputs_differing": res["outputs_differing"], "repeat_bitwise": True,
           "score_bound_units": worst, "output_bound_units": out_units,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, 20), "bound_ms": max(bytes_ms, op_ms),
           "bound_by": "bytes" if bytes_ms >= op_ms else "operations"}
    print(f"K2 {label:<34} S={S} KV={KV} rows={rows} D={D} BS={BS} NLOG={NLOG} "
          f"w={window} {rec['dtype']}, pools {rec['pools']}, chunks of {cp} pages "
          f"({n_chunks * KV} CTAs): Alg. 1 on own scores bitwise; repeat bitwise; "
          f"scores differing {res['scores_differing']} (worst, in units of the bound: "
          f"{worst}), outputs differing {res['outputs_differing']} (worst, in units of "
          f"the bound: {out_units}), max abs err {err:.3e} = {err / rms:.3e} of the "
          f"output's RMS {rms:.3e}; keys read {keys_read}; device ms: kernel "
          f"{rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f} "
          f"({rec['bound_by']}, {rec['bound_ms'] / rec['ms'] * 100:.1f}% of it); eager "
          f"call {rec['call_ms']:.4f}", flush=True)
    return rec


def phase5_k2(rate):
    """K2 against its plain version at the main path's decode shape and the
    matrix of the reference's paged-kernel tests (no int8)."""
    gen = torch.Generator("cuda").manual_seed(0)
    # the plain version's products in f32 accumulation throughout
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    main = dict(S=8, KV=16, group=1, D=128, BS=16, NLOG=36, NB=324)
    # positions as the serve run has them: prefix 384 + suffix 16..128,
    # then up to 64 new tokens
    qpos = np.random.default_rng(1).integers(400, 576, size=8)
    recs = [k2_case("decode (main path)", gen, rate, qpos=qpos, **main)]
    recs.append(k2_case("GQA group 4 (H 32, KV 8)", gen, rate, **{**main, "KV": 8, "group": 4}))
    recs.append(k2_case("GQA group 8 (H 32, KV 4)", gen, rate, **{**main, "KV": 4, "group": 8}))
    recs.append(k2_case("window 256", gen, rate, window=256, **main))
    recs.append(k2_case("block size 8", gen, rate, **{**main, "BS": 8, "NLOG": 72, "NB": 648}))
    recs.append(k2_case("block size 64", gen, rate, **{**main, "BS": 64, "NLOG": 9, "NB": 81}))
    recs.append(k2_case("4096-token rows", gen, rate, S=4, KV=16, group=1, NLOG=256,
                        qpos=np.array([4095, 4000, 3000, 2049])))
    recs.append(k2_case("sentinel tails + parked slot", gen, rate, qpos=qpos,
                        parked=(0, 5), **main))
    recs.append(k2_case("T 3 (verify rows)", gen, rate, T=3, **main))
    recs.append(k2_case("f32 compute", gen, rate, dtype=torch.float32, **main))
    recs.append(k2_case("bf16 scores", gen, rate, scores_dtype=torch.bfloat16, **main))
    recs.append(k2_case("32768-token row, rows 1", gen, rate, S=1, KV=16, group=1,
                        NLOG=2048, qpos=np.array([32767])))
    # past the whole-row design's shared memory (it raised on these)
    recs.append(k2_case("T 5 at 16384 keys", gen, rate, S=2, KV=16, group=1, T=5,
                        NLOG=1024, qpos=np.array([16379, 12000])))
    recs.append(k2_case("GQA group 7 (H 28, KV 4), 16384", gen, rate, S=2, KV=4, group=7,
                        NLOG=1024, qpos=np.array([16383, 9000])))
    recs.append(k2_case("rows 35 (group 7 x T 5), 32768", gen, rate, S=1, KV=4, group=7,
                        T=5, NLOG=2048, qpos=np.array([32763])))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    return recs


def phase9_k2_int8(rate):
    """K2's int8 branch against its plain version: the olmo serve decode
    shape with absmax and with power-of-two (exaq) scales, sentinel tails
    and parked slots, a 4096-token row, f32 compute; phase 5's checks."""
    gen = torch.Generator("cuda").manual_seed(1)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    main = dict(S=8, KV=16, group=1, D=128, BS=16, NLOG=36, NB=324)
    qpos = np.random.default_rng(1).integers(400, 576, size=8)
    recs = [k2_case("int8 decode (main path)", gen, rate, qpos=qpos, quant="absmax", **main)]
    recs.append(k2_case("int8 decode, exaq scales", gen, rate, qpos=qpos, quant="exaq",
                        **main))
    recs.append(k2_case("int8 sentinel tails + parked slot", gen, rate, qpos=qpos,
                        parked=(0, 5), quant="absmax", **main))
    recs.append(k2_case("int8 4096-token rows", gen, rate, S=4, KV=16, group=1, NLOG=256,
                        qpos=np.array([4095, 4000, 3000, 2049]), quant="absmax"))
    recs.append(k2_case("int8 f32 compute", gen, rate, dtype=torch.float32, qpos=qpos,
                        quant="absmax", **main))
    recs.append(k2_case("int8 32768-token row, rows 1", gen, rate, S=1, KV=16, group=1,
                        NLOG=2048, qpos=np.array([32767]), quant="absmax"))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    return recs


# ----------------------------------------------------------------- phase 12


# Bounds of K3 (tier (b)): in bf16 the kernel's dots and PV run on tensor
# cores (mma.sync m16n8k16): each score is within _mma_dot_bound (d in
# 16-deep steps) of the exact product, times the scale, plus the scale's
# rounding; each output within _pv_sums(..., mma=True) over one key-order
# chunk (16 keys a step; the kernel accumulates every key tile of a row in
# key order in registers) of the exact sum over its own probabilities. In
# f32 both are fmaf chains: a score within D 2^-24 sum |q_i k_i|, an output
# within n 2^-24 sum |p| |v| over its n valid keys. Against the plain
# version's (cuBLAS, f32, in an order not known here) the two sides' bounds
# add, and outputs also by sum_j |p_j - p'_j| |v_j|.
# The share check: a bf16 score is the tensor cores' f32 sum, which is not
# the exactly rounded f32 dot in most places (each of the d / 16 steps
# truncates), so the share of scores that differ from it at all is printed
# for information; at most 1 % may lie more than a quarter of a bf16 ulp
# from it, which a bf16 rounding of the scores (half a bf16 ulp) breaks for
# about half of them.
K3_SHARE_BF16_ULPS = 0.25
K3_BOUND_ELEMS = 1 << 26      # f64 terms of one bound evaluation (512 MB)


def k3_checks(x, *, q, k, v, cfg, causal, window, want, want_sc, want_pr):
    """K3's checks on one result ``x = (out, scores, probs)`` ([BH, Sq, D],
    [BH, Sq, Skv] x 2), the kernel's or a stand-in's (``--fault-control``),
    against the plain version's ``want``: (a) whether the plain Alg. 1 on
    its own scores gives its probabilities bitwise; (b) its scores in units
    of their bounds (above) from the exact products and from the plain
    version's, the shares of them off the exactly rounded f32 dot, and its
    outputs in units of their bounds from the exact sum over its own
    probabilities and from the plain version's. One head and one block of
    rows at a time, over the keys some row of the block attends. Returns
    them; raises nothing."""
    from repro_torch.core.alg1 import int_softmax_block
    from repro_torch.kernels.int_attention.ref import attention_mask, k3_span

    out, sc, pr = x
    bh, sq, d = q.shape
    bkv, skv = k.shape[:2]
    g, dtype, scale = bh // bkv, q.dtype, d ** -0.5
    mma = dtype == torch.bfloat16
    mask = attention_mask(sq, skv, causal, window, device=q.device)
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device) if mask is None else mask
    res = {"alg1_bitwise": bool(torch.equal(int_softmax_block(sc, valid, cfg), pr))}
    worst = {"vs_exact": 0.0, "vs_plain": 0.0, "plain_vs_exact": 0.0}
    out_units = {"pv_vs_exact": 0.0, "vs_plain": 0.0}
    n_live = n_off = n_far = 0

    def units(y, ref, err, live):
        tol = err * scale + 2.0 ** -23 * torch.maximum(y.abs(), ref.abs())
        return float(((y - ref).abs() / (tol * 1.001))[live].max())

    def worse(acc, key, u):
        acc[key] = max(acc[key], u)

    rows_blk = max(1, K3_BOUND_ELEMS // (skv * d))
    for hh in range(bh):
        kd, vd = k[hh // g].double(), v[hh // g].double()
        for r_a in range(0, sq, rows_blk):
            r_b = min(sq, r_a + rows_blk)
            lo, hi = k3_span(r_a, r_b - r_a, sq, skv, causal, window)
            o, w = out[hh, r_a:r_b].double(), want[hh, r_a:r_b].double()
            if hi <= lo:                        # no valid key: the sums are empty
                worse(out_units, "pv_vs_exact", 0.0 if bool((o == 0).all()) else float("inf"))
                worse(out_units, "vs_plain", 0.0 if bool((o == w).all()) else float("inf"))
                continue
            a, e = lo // 16 * 16, hi            # 16-key steps from a multiple of 16
            live = valid[r_a:r_b, a:e]
            qd, kk, vv = q[hh, r_a:r_b].double(), kd[a:e], vd[a:e]
            dots = qd @ kk.T
            plain_err = d * 2.0 ** -24 * (qd.abs() @ kk.abs().T)
            own_err = _mma_dot_bound(qd[None], kk[None])[0] if mma else plain_err
            s_k, s_p = sc[hh, r_a:r_b, a:e].double(), want_sc[hh, r_a:r_b, a:e].double()
            worse(worst, "vs_exact", units(s_k, dots * scale, own_err, live))
            worse(worst, "vs_plain", units(s_k, s_p, own_err + plain_err, live))
            worse(worst, "plain_vs_exact", units(s_p, dots * scale, plain_err, live))
            ex32 = (dots.float() * scale).double()  # the exactly rounded dot, scaled in f32
            n_live += int(live.sum())
            n_off += int(((s_k != ex32) & live).sum())
            n_far += int((((s_k - ex32).abs() > K3_SHARE_BF16_ULPS
                           * _ulp(ex32, torch.bfloat16)) & live).sum())
            del dots, plain_err, own_err, s_k, s_p, ex32
            p = pr[hh, r_a:r_b, a:e].to(dtype).double()
            wp = want_pr[hh, r_a:r_b, a:e].to(dtype).double()
            n_v = live.sum(-1, keepdim=True).double()
            if mma:
                e_k, tol_pv = (t[0, 0] for t in _pv_sums(
                    pr[hh, r_a:r_b, a:e][None, None], vv[None, :, None], dtype, [[(0, e - a)]],
                    mma=True))
            else:
                e_k, tol_pv = p @ vv, n_v * 2.0 ** -24 * (p.abs() @ vv.abs())
            tol_out = ((p - wp).abs() @ vv.abs() + tol_pv
                       + n_v * 2.0 ** -24 * (wp.abs() @ vv.abs()))
            worse(out_units, "pv_vs_exact", float(((o - e_k).abs()
                                                   / (tol_pv * 1.001 + 1e-300)).max()))
            worse(out_units, "vs_plain", float(((o - w).abs() / (tol_out * 1.001 + 1e-300)).max()))
    res["score_bound_units"] = worst
    res["output_bound_units"] = out_units
    res["score_share_differing"] = {"vs_exact": n_off / max(n_live, 1),
                                    "beyond_quarter_bf16_ulp": n_far / max(n_live, 1)}
    res["scores_differing"] = int(((sc != want_sc) & valid).sum())
    res["finite"] = bool(torch.isfinite(out).all())
    res["max_abs_err"] = float((out - want).abs().max())
    res["out_rms"] = float(want.double().pow(2).mean().sqrt())
    return res


def k3_case(label, rate, launch_calls, *, B, H, KV, Sq, Skv, D, causal=True, window=0,
            dtype=torch.bfloat16, seed=0, cfg=None):
    """K3 against its plain version on one input: the checks of ``k3_checks``
    must pass (Alg. 1 on its own scores bitwise, scores and outputs within
    their bounds, in bf16 at most 1 % of scores beyond a quarter of a bf16
    ulp of the exactly rounded dot); a second run gives the same bits; the
    kernel writes scores exactly at the key tiles of ``ref.k3_plan``; its
    shared memory is ``ref.k3_smem_bytes``. Returns its record and adds its
    call to ``launch_calls`` (``launch_checks``: one CUDA launch of
    k3_attention a call)."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.int_attention import ops
    from repro_torch.kernels.int_attention.ref import (
        attention_mask, int_attention_ref, k3_plan, k3_smem_bytes, k3_tiles,
    )

    cfg = cfg or BEST
    gen = torch.Generator("cuda").manual_seed(seed)
    dev = torch.device("cuda")
    bh, bkv = B * H, B * KV
    q = torch.randn((bh, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((bkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((bkv, Skv, D), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)

    def run():
        sc = torch.full((bh, Sq, Skv), float("nan"), device=dev)  # unvisited keys stay NaN
        pr = torch.zeros_like(sc)
        return ops.int_attention_rows(q, k, v, cfg, scores_out=sc, probs_out=pr, **kw), sc, pr

    before = ops.int_attention_rows.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    check(ops.int_attention_rows.launches == before + 2, f"K3 {label}: wrapper did not launch")
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, again)),
          f"K3 {label}: a second run gave other bits")
    del again
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = k3_plan(Sq, Skv, causal, window, *k3_tiles(dtype, D, bh, Sq, sms))
    check(torch.equal(~torch.isnan(got[1]), plan.visited(Sq, Skv, dev).expand(bh, Sq, Skv)),
          f"K3 {label}: the kernel's score writes are not the plan's key tiles")
    smem = ops.smem_bytes(dtype, D, cfg.M)
    check(smem == k3_smem_bytes(D, dtype, cfg.M),
          f"K3 {label}: the kernel takes {smem} B of shared memory, the plan says "
          f"{k3_smem_bytes(D, dtype, cfg.M)}")
    want, want_sc, want_pr = int_attention_ref(q[None], k[None], v[None], cfg,
                                               return_rows=True, **kw)
    res = k3_checks(got, q=q, k=k, v=v, cfg=cfg, want=want[0], want_sc=want_sc,
                    want_pr=want_pr, **kw)
    worst, out_units = res["score_bound_units"], res["output_bound_units"]
    share = res["score_share_differing"]
    err, rms = res["max_abs_err"], res["out_rms"]
    check(res["alg1_bitwise"],
          f"K3 {label}: plain Alg. 1 on the kernel's scores != the kernel's probabilities")
    check(res["finite"], f"K3 {label}: non-finite output")
    check(worst["vs_exact"] <= 1 and worst["vs_plain"] <= 1, f"K3 {label}: a score is "
          f"outside its bound ({worst}, in units of the bound)")
    if dtype == torch.bfloat16:
        check(share["beyond_quarter_bf16_ulp"] <= 0.01,
              f"K3 {label}: {share['beyond_quarter_bf16_ulp']:.2%} of the scores lie more "
              "than a quarter of a bf16 ulp from the exactly rounded dot (limit 1 %)")
    check(out_units["pv_vs_exact"] <= 1 and out_units["vs_plain"] <= 1, f"K3 {label}: an "
          f"output is outside its bound ({out_units}, in units of the bound)")
    out = got[0]
    del got, want_sc, want_pr
    # bound: q, k, v read once and the f32 out written once; operations: the
    # dot and the PV per valid (row, key) at the operand type's rate, Alg. 1
    # per valid score
    mask = attention_mask(Sq, Skv, causal, window, device=dev)
    esz = torch.finfo(dtype).bits // 8
    pairs = (Sq * Skv if mask is None else int(mask.sum())) * bh
    nbytes = (q.numel() + k.numel() + v.numel()) * esz + out.numel() * 4
    bytes_ms = nbytes / rate * 1e3
    op_ms = ops_ms(pairs * 4 * D, dtype, pairs * K1_OPS_PER_ELEMENT)
    kernel = lambda: ops.int_attention_rows(q, k, v, cfg, **kw)  # noqa: E731
    plain = lambda: int_attention_ref(q[None], k[None], v[None], cfg, **kw)  # noqa: E731
    rec = {"shape": label, "B": B, "H": H, "KV": KV, "Sq": Sq, "Skv": Skv, "D": D,
           "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1], "M": cfg.M,
           "q_tile": plan.q_tile, "k_tile": plan.k_tile, "ctas": plan.ctas(bh),
           "key_tiles_visited": plan.tiles_visited * bh, "smem_bytes": smem,
           "repeat_bitwise": True,
           "max_abs_err": err, "max_err_over_rms": err / rms, "out_rms": rms,
           "scores_differing": res["scores_differing"], "score_share_differing": share,
           "score_bound_units": worst, "output_bound_units": out_units,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, 10), "bound_ms": max(bytes_ms, op_ms),
           "bound_by": "bytes" if bytes_ms >= op_ms else "operations"}
    print(f"K3 {label:<34} B={B} H={H} KV={KV} Sq={Sq} Skv={Skv} D={D} causal={causal} "
          f"w={window} {rec['dtype']} M={cfg.M}: plan q tile {plan.q_tile} x key tile "
          f"{plan.k_tile} ({rec['ctas']} CTAs, {rec['key_tiles_visited']} key tiles, {smem} B "
          f"shared); Alg. 1 on own scores "
          f"bitwise; repeat bitwise; scores differing from plain {res['scores_differing']} "
          f"(worst, in units of the bound: {worst}; share off the exactly rounded dot "
          f"{share['vs_exact']:.4%}, beyond a quarter bf16 ulp "
          f"{share['beyond_quarter_bf16_ulp']:.4%}), outputs (worst, in units of the bound: "
          f"{out_units}), max abs err {err:.3e} = {err / rms:.3e} of the output's RMS "
          f"{rms:.3e}; device ms: kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, bound "
          f"{rec['bound_ms']:.4f} ({rec['bound_by']}, {rec['bound_ms'] / rec['ms'] * 100:.1f}% "
          f"of it); eager call {rec['call_ms']:.4f}", flush=True)
    launch_calls.append((f"K3 {label}", kernel, "k3_attention", rec))
    return rec


def phase12_k3(rate):
    """K3 (the stand-alone fused prefill attention) against its plain
    version on the reference's kernel matrix, at full widths and at the
    shapes the whole-row design refused or ran slowest; then its path:
    ``int_attention`` called as a user calls it, at olmo-1b's prefill width,
    with the launch count read around it."""
    from repro_torch.core.precision import BEST, PrecisionConfig
    from repro_torch.kernels.int_attention import ops

    # the kernel's branch-free division by S against IEEE division, over
    # every f32 value x - m it may divide, at each config phase 12 runs
    m15 = PrecisionConfig(M=15, T_C=-1.0, P_out_override=24)
    m4 = PrecisionConfig(M=4, T_C=-4.0)
    for name, cfg in (("BEST", BEST), ("M=15", m15), ("M=4 T_C=-4", m4)):
        bad = ops.division_mismatches(cfg)
        check(bad == 0, f"K3: {bad} values in [T_C, 0] get another exp index from the "
              f"branch-free division at {name}")
        print(f"K3 division at {name}: every f32 in [{cfg.T_C}, 0] gets the exp index of "
              "IEEE division (0 differ)", flush=True)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    recs, calls = [], []

    def case(label, **kw):
        recs.append(k3_case(label, rate, calls, **kw))

    # tests/test_kernels.py:61-101: f32, causal on and off, a window, bf16
    for i, (b, h, kv, sq, skv, d) in enumerate([(2, 4, 2, 64, 64, 32), (1, 8, 8, 96, 96, 64),
                                                (2, 4, 1, 33, 33, 32), (1, 2, 2, 16, 64, 32)]):
        for causal in (True, False):
            case(f"reference {b}x{h}/{kv}x{sq}x{skv}x{d} causal={causal}", B=b, H=h, KV=kv,
                 Sq=sq, Skv=skv, D=d, causal=causal, dtype=torch.float32, seed=10 * i + causal)
    case("reference window 16", B=1, H=4, KV=2, Sq=64, Skv=64, D=32, window=16,
         dtype=torch.float32, seed=100)
    case("reference bf16 inputs", B=1, H=4, KV=4, Sq=32, Skv=32, D=32, seed=101)
    case("olmo-1b prefill (main)", B=4, H=16, KV=16, Sq=512, Skv=512, D=128, seed=102)
    case("4096-token prefill", B=1, H=16, KV=16, Sq=4096, Skv=4096, D=128, seed=103)
    case("GQA H 32 KV 8, 2048 tokens", B=1, H=32, KV=8, Sq=2048, Skv=2048, D=128, seed=104)
    # the tiles' edges: a right-aligned tail, ragged query tiles, a window,
    # rows that see no key, d 64 and d 256 (Q in shared memory), f32 at d
    # 256, M=15 (no exp table), and a context the whole-row design refused
    case("128-token tail on 512 keys", B=1, H=16, KV=16, Sq=128, Skv=512, D=128, seed=105)
    case("ragged Sq 1000", B=2, H=16, KV=16, Sq=1000, Skv=1000, D=128, seed=106)
    case("4096 tokens, window 1024", B=1, H=16, KV=16, Sq=4096, Skv=4096, D=128, window=1024,
         seed=107)
    case("bf16 at d 64, GQA 8/2", B=2, H=8, KV=2, Sq=512, Skv=512, D=64, seed=108)
    case("Sq 40 on Skv 32 (all-masked rows)", B=1, H=4, KV=4, Sq=40, Skv=32, D=128, seed=109)
    case("bf16 at d 256, not causal", B=1, H=4, KV=4, Sq=200, Skv=300, D=256, causal=False,
         seed=110)
    case("f32 at d 256, window 5", B=1, H=2, KV=1, Sq=100, Skv=130, D=256, window=5,
         dtype=torch.float32, seed=111)
    case("bf16 at d 24, M=15 (no exp table)", B=1, H=4, KV=2, Sq=70, Skv=90, D=24, seed=112,
         cfg=m15)
    case("64 queries on 65536 keys", B=1, H=4, KV=4, Sq=64, Skv=65536, D=128, seed=113)
    launch_checks("K3", calls)
    del calls
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    # the stand-alone path, as a user calls it
    gen = torch.Generator("cuda").manual_seed(102)
    q, k, v = (torch.randn((4, 16, 512, 128), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    ops.int_attention_rows.launches = 0
    out = ops.int_attention(q, k, v, BEST, causal=True)
    torch.cuda.synchronize()
    launches = ops.int_attention_rows.launches
    check(launches == 1, f"K3 launched {launches} times in one int_attention call")
    check(out.shape == q.shape and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), "int_attention: output shape, type or values")
    print(f"K3 path: int_attention on [4, 16, 512, 128] bf16, causal: {launches} launch, "
          f"f32 output {tuple(out.shape)} finite", flush=True)
    return recs, launches


# ----------------------------------------------------------------- phase 7

# The MLA serve path's shapes (phase 8): minicpm3-4b at full width behind a
# 384-token shared prefix.
MLA_TRACE = dict(prefix_len=384, suffix_lens=(16, 64, 128), max_new_range=(16, 32), seed=0,
                 arrival_spacing=2.0)
# 8 requests (16 before phase 13 took the time of the other 8)
MLA_REQUESTS, MLA_SLOTS, MLA_BS = 8, 8, 16


def _mla_trace():
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.scheduler import shared_prefix_trace

    return shared_prefix_trace(MLA_REQUESTS, get_config("minicpm3-4b").vocab, **MLA_TRACE)


def _k4_inputs(gen, rng, *, S, H, T, R, DR, BS, NLOG, NB, dtype, qpos, parked, mixed):
    """Random queries and pools. Each slot owns distinct random blocks, then
    sentinels: through the page of its last position plus 2 (capped at
    NLOG), or — ``mixed``, as the reference's kernel tests — a random
    number of pages with its positions inside them. A parked slot sits at
    position NLOG * BS with an all-sentinel row."""
    dev = torch.device("cuda")
    rows = T * H
    q_lat = torch.randn((S, rows, R), generator=gen, device=dev).to(dtype)
    q_rope = torch.randn((S, rows, DR), generator=gen, device=dev).to(dtype)
    c = torch.randn((NB, BS, R), generator=gen, device=dev).to(dtype)
    kr = torch.randn((NB, BS, DR), generator=gen, device=dev).to(dtype)
    perm = rng.permutation(NB)
    table = np.full((S, NLOG), NB, np.int32)
    positions = np.zeros((S, T), np.int32)
    used = 0
    for s in range(S):
        if s in parked:
            positions[s] = NLOG * BS
            continue
        if mixed:
            n = int(rng.integers(1, NLOG + 1))
            positions[s] = int(rng.integers(0, n * BS - T + 1)) + np.arange(T)
        else:
            positions[s] = qpos[s] + np.arange(T)
            n = min(NLOG, int(positions[s].max()) // BS + 3)
        table[s, :n] = perm[used:used + n]
        used += n
    assert used <= NB
    return (q_lat, q_rope, c, kr, torch.as_tensor(table, device=dev),
            torch.as_tensor(positions, device=dev))


def k4_key_chunks(table, pos, *, rows, BS):
    """K4's chunk size and its chunks per slot as key ranges ``[(first,
    end), ...]``."""
    from repro_torch.kernels.paged_attention.ref import k2_chunks, k2_span, k4_split_plan

    S, nlog = table.shape
    cp = k4_split_plan(S, rows, nlog, BS,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    spans = [k2_span(p, nlog, BS) for p in pos.cpu().tolist()]
    return cp, [[(a * BS, b * BS) for a, b in k2_chunks(lo, hi, cp)] for lo, hi in spans]


def k4_checks(x, *, q_lat, q_rope, c, kr, table, pos, scale, chunks, want, want_sc,
              want_pr):
    """K4's checks on one result ``x = (out, scores, probs)``, the kernel's
    or a stand-in's (``--fault-control``), against the plain version's
    ``want``: (a) whether the plain Alg. 1 on its own scores gives its
    probabilities bitwise; (b) its scores in units of the bounds below from
    the exactly rounded products and from the plain version's, the share of
    them off the f32 sum of the exactly rounded dots, and its outputs in
    units of the bounds of phase 5 (the kernel's summation tree over
    ``chunks``, on tensor cores in bf16) from the exact sum over its own
    probabilities and from the plain version's. Returns them; raises
    nothing."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref
    from repro_torch.models.attention import paged_gather

    out, sc, pr = x
    S, rows, l_full = sc.shape
    NB, BS, R = c.shape
    H = rows // pos.shape[1]
    dtype = q_lat.dtype
    mma = dtype == torch.bfloat16
    # (a) the Alg.-1 step, bitwise, on its own scores
    kpos = torch.arange(l_full, device="cuda")
    valid = (kpos <= pos.repeat_interleave(H, dim=1)[:, :, None])          # [S, ROWS, L]
    again = int_softmax_ref(sc.reshape(-1, l_full), BEST,
                            valid.reshape(-1, l_full)).reshape(sc.shape)
    res = {"alg1_bitwise": bool(torch.equal(again, pr))}
    del again
    # (b) scores: each of the two dots may be one compute-dtype ulp plus its
    # f32 summation bound from the exactly rounded product: the plain
    # version's n 2^-24 sum |q_i c_i| (cuBLAS, rounding to nearest in an
    # order not known here), the kernel's the same for f32 (fmaf in element
    # order) or _mma_dot_bound for bf16 (tensor cores); the f32 add and
    # scale round once each
    cg, krg = paged_gather(c, table).double(), paged_gather(kr, table).double()
    pairs = ((q_lat.double(), cg), (q_rope.double(), krg))
    dots = [torch.einsum("srk,slk->srl", q, g) for q, g in pairs]
    plain_err = [q.shape[-1] * 2.0 ** -24 * torch.einsum("srk,slk->srl", q.abs(), g.abs())
                 for q, g in pairs]
    own_err = [_mma_dot_bound(q, g) for q, g in pairs] if mma else plain_err
    exact = ((dots[0].to(dtype).float() + dots[1].to(dtype).float()) * scale).double()
    live = valid & ((table >= 0) & (table < NB))[:, kpos // BS][:, None, :]

    def units(y, ref, errs):
        tol = sum(_ulp(d.abs() + e, dtype) + e for d, e in zip(dots, errs))
        tol = tol * scale + 2.0 ** -22 * torch.maximum(y.abs(), ref.abs())
        return float(((y.double() - ref.double()).abs() / (tol * 1.001))[live].max())

    both = [a + b for a, b in zip(own_err, plain_err)]
    res["score_bound_units"] = {"vs_exact": units(sc, exact, own_err),
                                "vs_plain": units(sc, want_sc, both),
                                "plain_vs_exact": units(want_sc, exact, plain_err)}
    res["scores_differing"] = int(((sc != want_sc) & valid).sum())
    # (b') in bf16 a score equals the f32 sum of the exactly rounded dots
    # unless a dot's f32 sum straddles a bf16 rounding boundary; the share a
    # bf16 add of the two dots (the "semi" error) would move is printed
    n_live = int(live.sum())
    res["score_share_differing"] = {
        "vs_exact": int(((sc.double() != exact) & live).sum()) / n_live,
        "bf16_add_vs_exact": int(((((dots[0].to(dtype) + dots[1].to(dtype)).float()
                                    * scale).double() != exact) & live).sum()) / n_live}
    del dots, plain_err, own_err, both, krg, exact
    # outputs, as in phase 5 (the latent is the value)
    vg = cg[:, :, None]                                        # [S, L, 1, R]
    e_k, rec_k = _pv_sums(pr[:, None], vg, dtype, chunks, mma=mma)
    e_k, rec_k = e_k[:, 0], rec_k[:, 0]
    mass_p = torch.einsum("srl,slk->srk", want_pr.to(dtype).double().abs(), cg.abs())
    dp = torch.einsum("srl,slk->srk", (pr.to(dtype).double()
                                       - want_pr.to(dtype).double()).abs(), cg.abs())
    del cg, vg
    o, w = out.double(), want.double()
    n_valid = valid.sum(-1, keepdim=True).double()
    tol_pv = rec_k + 0.5 * _ulp(torch.maximum(o.abs(), e_k.abs() + rec_k), dtype)
    tol_out = dp + rec_k + n_valid * 2.0 ** -24 * mass_p + _ulp(torch.maximum(o.abs(),
                                                                               w.abs()), dtype)
    res["output_bound_units"] = {"pv_vs_exact": float(((o - e_k).abs() / tol_pv).max()),
                                 "vs_plain": float(((o - w).abs() / tol_out).max())}
    res["finite"] = bool(torch.isfinite(out).all())
    res["max_abs_err"] = float((o - w).abs().max())
    res["out_rms"] = float(w.pow(2).mean().sqrt())
    res["outputs_differing"] = int((out != want).sum())
    return res


def k4_case(label, gen, rate, *, S, H, T=1, R=256, DR=32, BS=16, NLOG=34, NB=None,
            dtype=torch.bfloat16, qpos=None, parked=(), mixed=False, scale=96 ** -0.5):
    """K4 against its plain version on one input: the checks of ``k4_checks``
    must pass (Alg. 1 on its own scores bitwise, scores and outputs within
    their bounds, in bf16 at most 1 % of scores off the f32 sum of the
    exactly rounded dots), and a second run must give the same bits.
    Returns its record."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import K4_TILE_ROWS, paged_attention_mla_ref

    NB = NB or S * NLOG + 4
    l_full = NLOG * BS
    rows = T * H
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    if qpos is None:
        qpos = rng.integers(l_full // 2, l_full - T + 1, size=S)
    q_lat, q_rope, c, kr, table, pos = _k4_inputs(
        gen, rng, S=S, H=H, T=T, R=R, DR=DR, BS=BS, NLOG=NLOG, NB=NB, dtype=dtype,
        qpos=qpos, parked=parked, mixed=mixed)
    args = (q_lat, q_rope, c, kr, table, pos, BEST)

    def run():
        sc = torch.zeros((S, rows, l_full), device="cuda")
        pr = torch.zeros_like(sc)
        out = ops.paged_attention_mla_rows(*args, scale=scale, scores_out=sc, probs_out=pr)
        return out, sc, pr

    got = run()
    again = run()
    want, want_sc, want_pr = paged_attention_mla_ref(*args, scale=scale, return_rows=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4 {label}: a second run gave other bits")
    del again
    cp, chunks = k4_key_chunks(table, pos, rows=rows, BS=BS)
    res = k4_checks(got, q_lat=q_lat, q_rope=q_rope, c=c, kr=kr, table=table, pos=pos,
                    scale=scale, chunks=chunks, want=want, want_sc=want_sc, want_pr=want_pr)
    worst, out_units = res["score_bound_units"], res["output_bound_units"]
    share = res["score_share_differing"]
    err, rms = res["max_abs_err"], res["out_rms"]
    check(res["alg1_bitwise"], f"K4 {label}: plain Alg. 1 on the kernel's scores != the "
          "kernel's probabilities")
    check(worst["vs_exact"] <= 1, f"K4 {label}: a score is outside the bound of the "
          f"exactly rounded products ({worst}, in units of the bound)")
    check(worst["vs_plain"] <= 1, f"K4 {label}: a score is outside the bound of the "
          f"plain version's ({worst}, in units of the bound)")
    if dtype == torch.bfloat16:
        check(share["vs_exact"] <= 0.01, f"K4 {label}: {share['vs_exact']:.2%} of the "
              "scores differ from the f32 sum of the exactly rounded dots (limit 1 %)")
    check(res["finite"], f"K4 {label}: non-finite output")
    check(out_units["pv_vs_exact"] <= 1, f"K4 {label}: an output is outside the bound of "
          f"the exact sum over its own probabilities ({out_units}, in units of the bound)")
    check(out_units["vs_plain"] <= 1, f"K4 {label}: an output is outside the bound of "
          f"the plain version's ({out_units}, in units of the bound; max abs err {err})")
    # bound: the latent and rope rows the function needs (keys at or below
    # some row's position, on a live page), the queries, out, table and
    # positions, each once; operations: both dots and the PV per needed
    # (row, key) at the operand type's rate, and Alg. 1
    esz = torch.finfo(dtype).bits // 8
    kpos = torch.arange(l_full, device="cuda")
    live = ((kpos <= pos.repeat_interleave(H, dim=1)[:, :, None])
            & ((table >= 0) & (table < NB))[:, kpos // BS][:, None, :])
    keys_read = int(live.any(dim=1).sum())                     # a slot's rows share keys
    row_keys = int(live.sum())
    out = got[0]
    nbytes = (keys_read * (R + DR) * esz + (q_lat.numel() + q_rope.numel() + out.numel())
              * esz + table.numel() * 4 + pos.numel() * 4)
    bytes_ms = nbytes / rate * 1e3
    op_ms = ops_ms(row_keys * (2 * (R + DR) + 2 * R), dtype, row_keys * K1_OPS_PER_ELEMENT)
    kernel = lambda: ops.paged_attention_mla_rows(*args, scale=scale)  # noqa: E731
    plain = lambda: paged_attention_mla_ref(*args, scale=scale)  # noqa: E731
    tiles, groups = -(-rows // K4_TILE_ROWS), -(-R // 64)
    n_chunks = sum(len(ch) for ch in chunks)
    rec = {"shape": label, "S": S, "H": H, "T": T, "rows": rows, "R": R, "DR": DR,
           "BS": BS, "NLOG": NLOG, "dtype": str(dtype).split(".")[-1], "chunk_pages": cp,
           "live_ctas": n_chunks * tiles, "pv_ctas": n_chunks * tiles * groups,
           "keys_read": keys_read,
           "max_abs_err": err, "max_err_over_rms": err / rms, "out_rms": rms,
           "scores_differing": res["scores_differing"],
           "outputs_differing": res["outputs_differing"], "repeat_bitwise": True,
           "score_share_differing": share,
           "score_bound_units": worst, "output_bound_units": out_units,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, 20), "bound_ms": max(bytes_ms, op_ms),
           "bound_by": "bytes" if bytes_ms >= op_ms else "operations"}
    print(f"K4 {label:<34} S={S} H={H} T={T} R={R} DR={DR} BS={BS} NLOG={NLOG} "
          f"{rec['dtype']}, chunks of {cp} pages ({rec['live_ctas']} CTAs, PV "
          f"{rec['pv_ctas']}): Alg. 1 on own scores bitwise; repeat bitwise; scores "
          f"differing {res['scores_differing']} (worst, in units of the bound: {worst}; "
          f"share differing from the exactly rounded dots' f32 sum {share['vs_exact']:.4%}, "
          f"a bf16 add's {share['bf16_add_vs_exact']:.2%}), outputs differing "
          f"{res['outputs_differing']} (worst, in units of the bound: {out_units}), max "
          f"abs err {err:.3e} = {err / rms:.3e} of the output's RMS {rms:.3e}; keys read "
          f"{keys_read}; device ms: kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, "
          f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}, "
          f"{rec['bound_ms'] / rec['ms'] * 100:.1f}% of it); eager call {rec['call_ms']:.4f}",
          flush=True)
    return rec


def phase7_k4(rate):
    """K4 against its plain version at the MLA serve path's decode shape,
    the reference's MLA kernel matrix, long rows, parked slots, f32 compute
    and deepseek-v2's width."""
    gen = torch.Generator("cuda").manual_seed(0)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    need = max(r.prompt_len + r.max_new for r in _mla_trace())
    nlog = -(-need // MLA_BS)
    main = dict(S=MLA_SLOTS, H=40, R=256, DR=32, BS=MLA_BS, NLOG=nlog,
                NB=(MLA_SLOTS + 1) * nlog)
    # positions as the serve run has them: prefix 384 + suffix 16..128, then
    # up to 32 new tokens
    qpos = np.random.default_rng(1).integers(400, nlog * MLA_BS, size=MLA_SLOTS)
    recs = [k4_case("decode (main path)", gen, rate, qpos=qpos, **main)]
    for bs, nl, t in ((8, 4, 1), (16, 4, 3), (64, 2, 1)):
        recs.append(k4_case(f"reference matrix BS {bs} NLOG {nl} T {t}", gen, rate, S=3, H=4,
                            T=t, R=64, DR=16, BS=bs, NLOG=nl, NB=3 * nl + 2, mixed=True,
                            scale=(64 // 2 + 16) ** -0.5))
    recs.append(k4_case("4096-token rows", gen, rate, S=4, H=40, NLOG=256,
                        qpos=np.array([4095, 4000, 3000, 2049])))
    recs.append(k4_case("sentinel tails + parked slots", gen, rate, qpos=qpos, parked=(0, 5),
                        **main))
    recs.append(k4_case("f32 compute", gen, rate, dtype=torch.float32, qpos=qpos, **main))
    recs.append(k4_case("deepseek-v2 width", gen, rate, S=2, H=128, R=512, DR=64, NLOG=32,
                        qpos=np.array([511, 400]), scale=(128 + 64) ** -0.5))
    # past the whole-row design's reach or speed: minicpm3's max_seq, and
    # two head tiles (verify rows, deepseek-v2's 128 heads) over long rows
    recs.append(k4_case("32768-token row (max_seq)", gen, rate, S=1, H=40, NLOG=2048,
                        qpos=np.array([32767])))
    recs.append(k4_case("T 3 at 4096 keys", gen, rate, S=2, H=40, T=3, NLOG=256,
                        qpos=np.array([4093, 3000])))
    recs.append(k4_case("deepseek-v2 width, 4096 keys", gen, rate, S=2, H=128, R=512,
                        DR=64, NLOG=256, qpos=np.array([4095, 3000]),
                        scale=(128 + 64) ** -0.5))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    return recs


# ----------------------------------------------------------------- phase 4


def phase4_main_path():
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    batch, prompt_len, max_new = 4, 512, 32
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)                       # bf16 on the card
    params = model.init(torch.Generator("cuda").manual_seed(0))
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)
    prompts = corpus.sample(batch, prompt_len, seed=777)[:, :prompt_len]
    print(f"main path: {cfg.name} ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}), bf16 seeded weights, "
          f"softmax int_pallas, batch {batch}, prompt {prompt_len}, "
          f"max_new {max_new}, fused", flush=True)
    eng = Engine(model, params, max_new=max_new)
    torch.cuda.reset_peak_memory_stats()

    ops.int_softmax_rows.launches = 0
    t0 = time.perf_counter()
    res = eng.generate(prompts, report_cost=True, mode="fused")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.int_softmax_rows.launches
    want = cfg.n_layers * max_new
    print(f"K1 launches in one generate: {launches} (expected {cfg.n_layers} layers "
          f"x {max_new} steps = {want})", flush=True)
    check(launches == want, f"K1 launched {launches} times, expected {want}")
    check(res.tokens.shape == (batch, prompt_len + max_new), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()), "token range")
    check(bool(torch.isfinite(res.logits).all()), "non-finite logits")

    # steady-state timing (host clock around synchronized work, 5 runs
    # each): prefill alone, then whole generates
    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    prefill_s = [wall(lambda: model.prefill(params, {"tokens": tokens},
                                            cache_len=prompt_len + max_new))[0]
                 for _ in range(5)]
    gen_s = []
    for _ in range(5):
        dt, res2 = wall(lambda: eng.generate(prompts, mode="fused"))
        check(np.array_equal(res2.tokens, res.tokens), "repeat generate differs")
        gen_s.append(dt)
    g_med, p_med = statistics.median(gen_s), statistics.median(prefill_s)
    step_ms = (g_med - p_med) / (max_new - 1) * 1e3
    print(f"generate (5 runs): median {g_med * 1e3:.1f} ms [min {min(gen_s) * 1e3:.1f}, "
          f"max {max(gen_s) * 1e3:.1f}] -> {batch * max_new / g_med:.1f} tok/s; first "
          f"call {first_s * 1e3:.1f} ms; prefill median {p_med * 1e3:.1f} ms; "
          f"{step_ms:.2f} ms per decode step (median generate - prefill, / "
          f"{max_new - 1}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"batch softmax AP cost: {res.cost.describe()}", flush=True)
    # what a decode step asks of the host: aten ops dispatched (plus the 16
    # K1 launches, which go through ctypes)
    _, cache = model.prefill(params, {"tokens": tokens}, cache_len=prompt_len + max_new)
    counter = _OpCount()
    with counter:
        model.decode_step(params, cache, {"token": tokens[:, :1]}, prompt_len)
    print(f"host work: {counter.n} aten ops per decode step (+{cfg.n_layers} K1 "
          f"launches) -> {step_ms / counter.n * 1e3:.1f} us of step time per op",
          flush=True)

    # the same weights with the plain torch Alg. 1 on the card
    plain = Engine(Model(cfg.with_softmax(SoftmaxSpec("int"))), params, max_new=max_new)
    res_int = plain.generate(prompts, mode="fused")
    check(np.array_equal(res_int.tokens, res.tokens), "int vs int_pallas tokens differ")
    check(torch.equal(res_int.logits, res.logits), "int vs int_pallas last logits differ")
    print("int_pallas vs int (plain Alg. 1) on the card: tokens and last logits "
          "bitwise equal", flush=True)
    del eng, plain, params, res, res2, res_int
    torch.cuda.empty_cache()

    # small input: the card against the CPU, same f32 weights
    scfg = smoke_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    cpu_model = Model(scfg, dtype=torch.float32, device="cpu")
    cpu_params = cpu_model.init(torch.Generator("cpu").manual_seed(0))
    gpu_params = _tree_to(cpu_params, "cuda")
    sp = SyntheticCorpus(scfg.vocab, seed=1234).sample(2, 8, seed=5)[:, :8]
    on_cpu = Engine(cpu_model, cpu_params, max_new=8).generate(sp)
    on_gpu = Engine(Model(scfg, dtype=torch.float32), gpu_params, max_new=8).generate(sp)
    err = float((on_gpu.logits.cpu() - on_cpu.logits).abs().max())
    check(np.array_equal(on_gpu.tokens, on_cpu.tokens), "smoke: card vs CPU tokens differ")
    check(err <= 1e-2, f"smoke: card vs CPU logits differ by {err}")
    print(f"smoke olmo-1b f32, card (K1) vs CPU (plain): greedy tokens equal, last "
          f"logits max abs diff {err:.3e} (bound 1e-2: a score on a rounding "
          f"boundary may quantize differently)", flush=True)
    return launches


# ----------------------------------------------------------------- phase 6

# A greedy divergence between two runs of the full-width model is accepted
# only where the reference run's top-2 logit margin at the first divergent
# step is below NEAR_TIE_ULPS bf16 ulps of that step's own top logit (one
# ulp is 2^-6 at a magnitude of 2-4, 2^-5 at 4-8). The kernels and cuBLAS
# differ by tier-(b) roundings that can move an Alg.-1 code and add up over
# the layers: on the H100 the divergences seen fell at margins of 0 to 4
# ulps (olmo-1b: 0 to 0.047 at top logits 3.4-3.9; minicpm3-4b: 0 to 0.125
# at 3.9-4.3).
NEAR_TIE_ULPS = 8


# Served logits against a teacher-forced pass, per request and step: the
# served tokens fed back through one causal forward (Model.train_logits)
# give the logits each step should have seen, with no KV cache, paged pool, prefix
# sharing, tail prefill or K2 in the way, and no sampling. Both sides are
# bf16 with different GEMM shapes (a step of 8 slots, a tail prefill, one
# whole-sequence forward), so their logits differ by roundings that add up
# over 16 layers; per-request eager generate against the same forward
# measures that floor without the serve machinery (on the H100: max 0.082,
# RMS 0.0150; the serve runs read max 0.109 and RMS 0.0153). A served logit
# may be LOGIT_TOL (16 bf16 ulps at the top logits' magnitude of 2-4) from
# the teacher-forced one, and the RMS of the differences over a run
# LOGIT_RMS_TOL (1.3 times that floor: an extra error of RMS 0.013 fails).
LOGIT_TOL = 0.25
LOGIT_RMS_TOL = 0.02

# The pallas and jnp serves compared step by step (aligned_logits): the same
# tokens through the same serve machinery, K2 against gather + cuBLAS + K1,
# so the floor is the kernels' tier-(b) roundings alone (on the H100: max
# 0.1157, RMS 0.01366). A logit may differ by LOGIT_TOL, the RMS by 1.3 times
# that floor.
ALIGNED_RMS_TOL = 0.0178

# The int8 serve path (phase 11) is held to the same limits: against a
# teacher-forced pass that quantizes K/V as the prefill does, its floors on
# the H100 equal bf16's within 1 % (per-request eager max 0.094, RMS
# 0.0152; step-aligned pallas vs jnp max 0.086, RMS 0.01366).

# The same rules on the MLA serve path (phase 8). The teacher-forced
# forward up-projects the latents while decode runs the absorbed form,
# which rounds at other places, so the floor is higher than olmo's:
# per-request eager read max 0.221 and RMS 0.0405 on the H100 over 62
# layers. A served logit may be 0.5 from the teacher-forced one (16 ulps
# at 4-8, where the top logits of the seeded minicpm3-4b reach; 2.3 times
# the floor's max), and the RMS is held to 1.3 times the floor's.
# ``python3 chip_smoke.py --fault-control`` reads known faults of the MLA
# decode against these limits.
MLA_LOGIT_TOL = 0.5
MLA_LOGIT_RMS_TOL = 0.053
# Step by step, pallas (K4) against jnp (gather, two einsums, K1), both in
# the absorbed form: max 0.125 and RMS 0.02153 on the H100; a logit may
# differ by 0.25, the RMS by 1.3 times the floor. This is the check that
# sees the bf16 score add and the masked current key of --fault-control.
MLA_ALIGNED_TOL = 0.25
MLA_ALIGNED_RMS_TOL = 0.028


class _LogitRecorder:
    """Greedy sampler that keeps every logits row it samples, by the seed
    of the request's generator (one generator per request)."""

    def __init__(self):
        self.rows = {}

    def __call__(self, logits, generator):
        self.rows.setdefault(generator.initial_seed(), []).append(logits[0].clone())
        return torch.argmax(logits, dim=-1).to(torch.int32)


def full_logits(model, params, seq):
    """Logits at every position of ``seq`` [1, S] from one causal pass:
    ``Model.train_logits``, or for an int8 KV cache the prefill's layer loop
    (each layer attends the fake-quantized K/V it caches, as serving does)
    with the head over every position."""
    if not model.cfg.kv_quant:
        return model.train_logits(params, {"tokens": seq})[0]
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import positions_for

    x = model._embed(params, seq)
    x, _ = tfm.stack_prefill(params["stack"]["layers"], x, model.cfg, model.ctx,
                             positions_for(seq.shape, device=seq.device), seq.shape[1])
    return model._head(params, x)


def teacher_forced(label, model, params, reqs, tokens, rows, tol, rms_tol):
    """Per run: the largest |served - teacher-forced| logit at the first
    step (the prefill or tail prefill) and at the decode steps, and the RMS
    of the differences over every logit of every step. ``tokens``: the
    served token row of each request; ``rows``: the recorder's rows. The
    teacher-forced pass is ``full_logits`` of ``model``."""
    first = decode = sq = 0.0
    n = 0
    for r, toks in zip(reqs, tokens):
        got = rows[r.seed]
        check(len(got) == r.max_new, f"{label}, request {r.rid}: {len(got)} sampled rows")
        seq = torch.as_tensor(np.asarray(toks[:-1])[None], dtype=torch.long,
                              device="cuda")
        ref = full_logits(model, params, seq)[0, r.prompt_len - 1:]
        d = (torch.stack(got).float() - ref.float()).abs()
        first = max(first, float(d[0].max()))
        if len(d) > 1:
            decode = max(decode, float(d[1:].max()))
        sq += float(d.double().pow(2).sum())
        n += d.numel()
    stats = {"run": label, "requests": len(reqs), "first_step_max": first,
             "decode_max": decode, "rms": (sq / n) ** 0.5}
    print(f"  teacher-forced logits, {label}: max |diff| {first:.4g} at the first step "
          f"(prefill or tail prefill), {decode:.4g} at decode steps, RMS {stats['rms']:.4g} "
          f"(limits {tol}, RMS {rms_tol})", flush=True)
    return stats


def aligned_logits(label, reqs, res_a, res_b, rows_a, rows_b):
    """Two serves of one trace, compared step by step: per request, the
    logits rows up to and including the first step whose greedy tokens
    differ (until then both runs fed the model the same tokens). Returns
    the largest |a - b| over those rows and their RMS."""
    top = sq = 0.0
    n = steps = 0
    for r, a, b in zip(reqs, res_a, res_b):
        diff = np.nonzero(np.asarray(a.tokens) != np.asarray(b.tokens))[0]
        k = int(diff[0]) - r.prompt_len if diff.size else r.max_new - 1
        d = (torch.stack(rows_a[r.seed][:k + 1]).float()
             - torch.stack(rows_b[r.seed][:k + 1]).float()).abs()
        top = max(top, float(d.max()))
        sq += float(d.double().pow(2).sum())
        n += d.numel()
        steps += k + 1
    stats = {"run": label, "steps": steps, "max": top, "rms": (sq / n) ** 0.5}
    print(f"  step-aligned logits, {label}: {steps} steps, max |diff| {top:.4g}, RMS "
          f"{stats['rms']:.4g}", flush=True)
    return stats


def _margin(model, params, tokens):
    """Top logit and top-2 margin of the next-token logits after ``tokens``,
    by a teacher-forced prefill of the reference's own tokens."""
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)[None], dtype=torch.long,
                                       device="cuda")}
    logits, _ = model.prefill(params, batch, cache_len=len(tokens))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0]), float(top[0] - top[1])


def first_divergence(label, got, want, prompt_len, model, params):
    """None for equal token rows; else the first divergent step with the
    reference's top logit and top-2 margin there, and whether that margin
    is a near tie (below NEAR_TIE_ULPS bf16 ulps of the top logit)."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if diff.size == 0:
        return None
    k = int(diff[0])
    check(k >= prompt_len, f"{label}: prompt differs")
    top, margin = _margin(model, params, want[:k])
    bound = NEAR_TIE_ULPS * 2.0 ** (float(np.floor(np.log2(abs(top)))) - 7)
    return {"run": label, "step": k - prompt_len, "margin": margin, "top": top,
            "near_tie_bound": bound, "near_tie": margin < bound}


def compare_tokens(label, got, want, prompt_len, model, params, ties):
    """Equal token rows, or a first divergence at a near tie of ``want``."""
    d = first_divergence(label, got, want, prompt_len, model, params)
    if d is None:
        return
    print(f"  divergence {label}: generated step {d['step']}, reference top-2 logit "
          f"margin {d['margin']:.4g} at top logit {d['top']:.4g} (near-tie bound "
          f"{d['near_tie_bound']:.4g})", flush=True)
    check(d["near_tie"], f"{label}: greedy tokens diverge at step {d['step']} with "
          f"margin {d['margin']} >= {d['near_tie_bound']}")
    ties.append(d)


def serve_phase(arch, reqs, opts, *, fused, eager_n, warm_runs, logit_tol, logit_rms_tol,
                aligned_tol, aligned_rms_tol, max_new, kv_quant=False):
    """Full-width ``arch`` served through Engine.serve with the paged pool,
    prefix sharing and ``kernel="pallas"``: the fused paged decode
    ``fused`` (the ``ops`` function whose counter it bumps) launches
    n_layers x steps times, K1 n_layers x requests (the prefills and tail
    prefills), no other paged decode kernel at all. Greedy tokens equal
    ``kernel="jnp"`` and per-request eager (the first ``eager_n`` requests)
    but at near ties; every served logit within ``logit_tol`` (RMS
    ``logit_rms_tol``) of a teacher-forced forward of the served tokens,
    and the pallas and jnp serves' logits within ``aligned_tol`` (RMS
    ``aligned_rms_tol``) of each other step by step;
    ``warm_runs`` warm runs per kernel, in turns, and one op-counted serve
    per kernel. ``kv_quant``: the int8 KV pool (absmax); K2 must then launch
    on int8 pools every time, and the teacher-forced pass quantizes as
    the prefill does."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.kernels.paged_attention import ops as paged
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config(arch, softmax=SoftmaxSpec("int_pallas")),
                              kv_quant=kv_quant)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    eng = Engine(model, params, max_new=max_new)
    gen_tokens = sum(r.max_new for r in reqs)
    counters = _kernel_counters()
    name = next(k for k, f in counters.items() if f is fused)
    print(f"serve path: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers), bf16 seeded weights, softmax int_pallas; {len(reqs)} "
          f"requests (prompts {min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, max_new {min(r.max_new for r in reqs)}-"
          f"{max(r.max_new for r in reqs)}, {gen_tokens} tokens), slots {opts.slots}, paged "
          f"bs {opts.block_size}, prefix_share, kernel pallas ({name}), KV pool "
          f"{'int8 (absmax)' if kv_quant else 'bf16'}", flush=True)

    # the checked runs sample through a recorder (greedy, per slot) that
    # keeps every logits row; the timed runs below use ``eng``
    rec = _LogitRecorder()
    eng_r = Engine(model, params, max_new=max_new, sampler=rec)
    for f in counters.values():
        f.launches = 0
    paged.paged_attention_rows.int8_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = eng_r.serve(reqs, opts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n = {k: f.launches for k, f in counters.items()}
    n["K2 on int8 pools"] = paged.paged_attention_rows.int8_launches
    rows_pallas, rec.rows = rec.rows, {}
    want = {k: 0 for k in n}
    want.update({"K1": cfg.n_layers * len(reqs), name: cfg.n_layers * rep.steps})
    if kv_quant:
        want["K2 on int8 pools"] = cfg.n_layers * rep.steps
    print(f"launches in one serve: {n} (expected {want}: {name} {cfg.n_layers} layers x "
          f"{rep.steps} steps, K1 {cfg.n_layers} x {len(reqs)} prefills); first serve "
          f"{first_s * 1e3:.1f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(n == want, f"kernel launches {n} != {want}")
    check(len(rep.results) == len(reqs), "not every request completed")
    for r, res in zip(reqs, rep.results):
        check(res.rid == r.rid and res.tokens.shape == (r.prompt_len + r.max_new,),
              f"request {r.rid}: token shape")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              f"request {r.rid}: token range")
    check(rep.shared_prefill_tokens > 0, "no prefix was shared")
    check(rep.leaked_blocks == 0, f"{rep.leaked_blocks} pool blocks leaked")
    check(cost_shares_sum(rep), "cost shares do not sum to the batch meter")
    print(f"served: {rep.steps} decode steps, cache_len {rep.cache_len}, prefill "
          f"{rep.prefill_tokens} tokens + shared {rep.shared_prefill_tokens}, cow copies "
          f"{rep.cow_copies}, evictions {rep.evictions}, leaked blocks {rep.leaked_blocks}; "
          f"per-request cost shares sum to the batch meter (rel 1e-9): "
          f"{rep.cost.describe()}", flush=True)
    pool_bytes = {q: pool_bytes_per_token(dataclasses.replace(cfg, kv_quant=q))
                  for q in (False, True)}
    print(f"KV pool bytes per token: {pool_bytes[cfg.kv_quant]} ({cfg.n_layers} layers; "
          f"int8 pool {pool_bytes[True]}, bf16 pool {pool_bytes[False]})", flush=True)

    ties = []
    rep_j = eng_r.serve(reqs, dataclasses.replace(opts, kernel="jnp", report_cost=False))
    rows_jnp, rec.rows = rec.rows, {}
    for a, b in zip(rep.results, rep_j.results):
        compare_tokens(f"pallas vs jnp, request {a.rid}", a.tokens, b.tokens,
                       a.prompt_len, model, params, ties)
    eager = []
    for r, res in list(zip(reqs, rep.results))[:eager_n]:
        ref = eng_r.generate(r.prompt[None],
                             generator=torch.Generator("cuda").manual_seed(r.seed),
                             mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        eager.append(ref)
        compare_tokens(f"serve vs eager, request {r.rid}", res.tokens, ref.tokens[0],
                       r.prompt_len, model, params, ties)
    print(f"greedy tokens: pallas == jnp for {len(reqs)} requests and serve == eager for "
          f"the first {eager_n}, {len(ties)} near-tie divergence(s)", flush=True)
    aligned = aligned_logits("pallas vs jnp", reqs, rep.results, rep_j.results, rows_pallas,
                             rows_jnp)
    check(aligned["max"] <= aligned_tol and aligned["rms"] <= aligned_rms_tol,
          f"pallas and jnp logits differ step by step beyond the limits ({aligned_tol}, "
          f"RMS {aligned_rms_tol}): {aligned}")
    logit_checks = [
        teacher_forced("serve kernel=pallas", model, params, reqs,
                       [res.tokens for res in rep.results], rows_pallas, logit_tol,
                       logit_rms_tol),
        teacher_forced("serve kernel=jnp", model, params, reqs,
                       [res.tokens for res in rep_j.results], rows_jnp, logit_tol,
                       logit_rms_tol),
        teacher_forced(f"eager generate, first {eager_n} requests (floor)", model, params,
                       reqs[:eager_n], [e.tokens[0] for e in eager], rec.rows, logit_tol,
                       logit_rms_tol)]
    for c in logit_checks:
        check(max(c["first_step_max"], c["decode_max"]) <= logit_tol and
              c["rms"] <= logit_rms_tol, f"{c['run']}: served logits differ from the "
              f"teacher-forced prefill's beyond the limits: {c}")
    to_bf16 = None
    if kv_quant:        # information only: what the int8 pool costs in logits
        to_bf16 = teacher_forced("int8 serve kernel=pallas vs the bf16 model (information)",
                                 Model(dataclasses.replace(cfg, kv_quant=False)), params,
                                 reqs, [res.tokens for res in rep.results], rows_pallas,
                                 float("inf"), float("inf"))
    del rec, eng_r, rows_pallas, rows_jnp

    # warm runs, in turns, median per kernel
    runs = {"pallas": [], "jnp": []}
    for _ in range(warm_runs):
        for kernel in ("pallas", "jnp"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r_k = eng.serve(reqs, dataclasses.replace(opts, kernel=kernel, report_cost=False))
            torch.cuda.synchronize()
            runs[kernel].append((time.perf_counter() - t0, r_k,
                                 torch.cuda.max_memory_allocated()))
    timing = {}
    for kernel, rs in runs.items():
        wall = statistics.median(dt for dt, _, _ in rs)
        r_k = rs[0][1]
        timing[kernel] = {"wall_ms": wall * 1e3, "tok_s": gen_tokens / wall,
                          "steps": r_k.steps, "ms_per_step": wall * 1e3 / r_k.steps,
                          "prefill_tokens": r_k.prefill_tokens,
                          "shared_tokens": r_k.shared_prefill_tokens,
                          "cow_copies": r_k.cow_copies,
                          "peak_gib": max(m for _, _, m in rs) / 2**30,
                          "wall_ms_runs": [dt * 1e3 for dt, _, _ in rs]}
        t = timing[kernel]
        print(f"serve kernel={kernel} ({warm_runs} warm run(s)): median wall "
              f"{t['wall_ms']:.1f} ms {[round(x, 1) for x in t['wall_ms_runs']]}, "
              f"{t['tok_s']:.1f} generated tok/s, {t['steps']} decode steps, "
              f"{t['ms_per_step']:.2f} ms per step (wall / steps, prefills included), prefill "
              f"{t['prefill_tokens']} tokens vs shared {t['shared_tokens']}, cow copies "
              f"{t['cow_copies']}, peak device memory {t['peak_gib']:.2f} GiB", flush=True)
    # what a step asks of the host: aten ops dispatched over one serve
    # (prefills included), per decode step; the kernels go through ctypes
    for kernel in ("pallas", "jnp"):
        counter = _OpCount()
        with counter:
            r_k = eng.serve(reqs, dataclasses.replace(opts, kernel=kernel, report_cost=False))
        timing[kernel]["aten_ops_per_step"] = counter.n / r_k.steps
        print(f"host work, kernel={kernel}: {counter.n} aten ops in one serve = "
              f"{counter.n / r_k.steps:.0f} per decode step (prefills included) -> "
              f"{timing[kernel]['ms_per_step'] / (counter.n / r_k.steps) * 1e3:.1f} us "
              "of step time per op", flush=True)
    return {"arch": arch, "kv_pool": "int8 (absmax)" if kv_quant else "bf16",
            "launches": n, "steps": rep.steps, "ties": ties,
            "teacher_forced_logits": logit_checks, "aligned_logits": aligned,
            "int8_vs_bf16_model_logits": to_bf16, "pool_bytes_per_token": pool_bytes,
            "timing": timing}


def pool_bytes_per_token(cfg) -> int:
    """Bytes the paged KV pool of ``cfg`` holds per token, every layer."""
    from repro_torch.models import kv_cache

    pool = kv_cache.paged_cache_zeros(cfg, 1, 16, 16, 1, device="meta")
    return sum(x.numel() * x.element_size() for k, x in pool.items() if k != "table") // 16


# Phase 6's trace and serve options (phases 11 and 13 reuse them).
SERVE_TRACE = dict(prefix_len=384, suffix_lens=(16, 64, 128), max_new_range=(16, 64), seed=0,
                   arrival_spacing=2.0)
SERVE_OPTIONS = dict(slots=8, paged=True, block_size=16, prefix_share=True, kernel="pallas",
                     report_cost=True)


def phase6_serve(kv_quant=False):
    """Full-width olmo-1b served through Engine.serve with the paged pool,
    prefix sharing and the fused paged decode K2; ``kv_quant``: from an
    int8 pool (phase 11). One warm serve per kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    reqs = shared_prefix_trace(32, get_config("olmo-1b").vocab, **SERVE_TRACE)
    opts = ServeOptions(**SERVE_OPTIONS)
    return serve_phase("olmo-1b", reqs, opts, fused=ops.paged_attention_rows, eager_n=4,
                       warm_runs=1, logit_tol=LOGIT_TOL, logit_rms_tol=LOGIT_RMS_TOL,
                       aligned_tol=LOGIT_TOL, aligned_rms_tol=ALIGNED_RMS_TOL, max_new=64,
                       kv_quant=kv_quant)


def phase10_kv_quantize():
    """kv_quantize on the card against the same call on the CPU, on the K/V
    of a full-width olmo-1b prefill of 512 tokens (every layer): absmax
    codes and scales bitwise; the EXAQ schemes bitwise, or each differing
    scale exactly one power of two from the CPU's (printed)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.models.attention import kv_quantize
    from repro_torch.models.model import Model

    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    prompt = SyntheticCorpus(cfg.vocab, seed=1234).sample(1, 512, seed=777)[:, :512]
    _, cache = model.prefill(params, {"tokens": torch.as_tensor(prompt, device="cuda")},
                             cache_len=512)
    del params, model
    out = {}
    for scheme in ("absmax", "exaq", "exaq_clamped"):
        rec = {"values": 0, "codes_differing": 0, "scales_differing": 0}
        for name in ("k", "v"):
            x = cache[name]                                   # [L, 1, 512, KV, D] bf16
            codes, scale = kv_quantize(x, scheme)
            c_cpu, s_cpu = kv_quantize(x.cpu(), scheme)
            codes, scale = codes.cpu(), scale.cpu()
            diff = scale != s_cpu
            rec["values"] += x.numel()
            rec["codes_differing"] += int((codes != c_cpu).sum())
            rec["scales_differing"] += int(diff.sum())
            if diff.any():
                ratio = torch.log2(scale[diff].double() / s_cpu[diff].double())
                print(f"  {scheme} {name}: scales differing at "
                      f"{torch.nonzero(diff)[:8].tolist()} (log2 ratio "
                      f"{ratio[:8].tolist()})", flush=True)
                check(scheme != "absmax" and bool((ratio.abs() == 1).all()),
                      f"kv_quantize {scheme}: card and CPU scales differ other than by one "
                      "power of two")
        check(scheme != "absmax" or rec["codes_differing"] == rec["scales_differing"] == 0,
              f"kv_quantize absmax: card and CPU differ: {rec}")
        print(f"kv_quantize {scheme}, card vs CPU on the K/V of a full-width 512-token "
              f"prefill ({rec['values']} values): codes differing {rec['codes_differing']}, "
              f"scales differing {rec['scales_differing']}", flush=True)
        out[scheme] = rec
    return out


def phase8_mla_serve():
    """Full-width minicpm3-4b (MLA) served through Engine.serve with the
    paged latent pool, prefix sharing and the fused absorbed-MLA decode
    K4."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serving.options import ServeOptions

    reqs = _mla_trace()
    opts = ServeOptions(slots=MLA_SLOTS, paged=True, block_size=MLA_BS, prefix_share=True,
                        kernel="pallas", report_cost=True)
    return serve_phase("minicpm3-4b", reqs, opts, fused=ops.paged_attention_mla_rows,
                       eager_n=2, warm_runs=1, logit_tol=MLA_LOGIT_TOL,
                       logit_rms_tol=MLA_LOGIT_RMS_TOL, aligned_tol=MLA_ALIGNED_TOL,
                       aligned_rms_tol=MLA_ALIGNED_RMS_TOL, max_new=32)


# ----------------------------------------------------------------- phase 13

# Chunked prefill and priority preemption: phase 6's trace with every fourth
# request in class 0 and the rest in class 1, served with phase 6's options
# plus prefill_chunk=CHUNK and preemption from a pool of POOL_REQUESTS
# requests' worst case (five, plus one request's slack for the prefix cache).
CHUNK = 128
POOL_REQUESTS = 6


def _kernel_counters():
    from repro_torch.kernels.int_attention import ops as k3
    from repro_torch.kernels.int_softmax import ops as k1
    from repro_torch.kernels.paged_attention import ops as paged

    return {"K1": k1.int_softmax_rows, "K2": paged.paged_attention_rows,
            "K3": k3.int_attention_rows, "K4": paged.paged_attention_mla_rows}


def cost_shares_sum(rep) -> bool:
    """The per-request cost shares sum to the batch meter (rel 1e-9)."""
    from repro_torch.backends import ZERO_COST

    summed = ZERO_COST
    for res in rep.results:
        summed = summed + res.cost
    return all(abs(float(getattr(summed, f)) - float(getattr(rep.cost, f)))
               <= 1e-9 * abs(float(getattr(rep.cost, f)))
               for f in ("vectors", "cycles", "latency_s", "energy_j"))


def phase13_trace():
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.serving.scheduler import shared_prefix_trace

    reqs = shared_prefix_trace(32, get_config("olmo-1b").vocab, **SERVE_TRACE)
    return [dataclasses.replace(r, priority=0 if r.rid % 4 == 0 else 1) for r in reqs]


def phase13_options(reqs, chunked=True):
    """Phase 6's options; ``chunked``: plus prefill_chunk, preemption and
    the phase's pool."""
    from repro_torch.serving.options import ServeOptions

    if not chunked:
        return ServeOptions(**SERVE_OPTIONS)
    bs = SERVE_OPTIONS["block_size"]
    worst = max(-(-(r.prompt_len + r.max_new) // bs) for r in reqs)
    return ServeOptions(**SERVE_OPTIONS, prefill_chunk=CHUNK, preemption=True,
                        num_blocks=POOL_REQUESTS * worst)


def counted_serve(eng, reqs, opts, rec):
    """One serve through ``eng`` (sampling through the recorder ``rec``),
    every kernel count set to 0 just before and read just after. Returns
    the report, the launches, the logit rows and the wall seconds."""
    from repro_torch.kernels.paged_attention import ops as paged

    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    paged.paged_attention_rows.int8_launches = 0
    rec.rows = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.serve(reqs, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: f.launches for k, f in counters.items()}
    n["K2 on int8 pools"] = paged.paged_attention_rows.int8_launches
    return rep, n, rec.rows, wall


def prefill_pieces(reqs, rep):
    """The prefill calls a chunked, preempting serve must make, from the
    trace, the chunk and the report's shared tokens: request r commits its
    P - s unshared prompt tokens in ceil((P - s) / CHUNK) pieces (whole
    when that is one). A resume that finds registered prompt blocks of its
    own evicted re-prefills them in one more piece; those tokens are the
    ones prefilled beyond the sum of P - s. Returns (pieces without
    re-prefills, re-prefilled tokens)."""
    base = sum(-(-(r.prompt_len - res.shared_prefix) // CHUNK)
               for r, res in zip(reqs, rep.results))
    reprefill = (rep.prefill_tokens + rep.shared_prefill_tokens
                 - sum(r.prompt_len for r in reqs))
    return base, reprefill


def phase13_gates(cfg, reqs, rep, n):
    """The chunked, preempting serve's scheduling and launch gates (name ->
    passed), and what they were computed from."""
    L, bs = cfg.n_layers, SERVE_OPTIONS["block_size"]
    base, reprefill = prefill_pieces(reqs, rep)
    # re-prefill pieces: none without re-prefilled tokens, else one per
    # resume that re-prefilled, each at least a block
    extra = (n["K1"] - L * base) // L
    k1_ok = n["K1"] % L == 0 and (
        extra == 0 if reprefill == 0 else 1 <= extra <= min(rep.resumes, reprefill // bs))
    gates = {
        "completed": len(rep.results) == len(reqs) and all(
            res.rid == r.rid and res.tokens.shape == (r.prompt_len + r.max_new,)
            and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
            for r, res in zip(reqs, rep.results)),
        "preempted": rep.preemptions >= 1 and rep.resumes == rep.preemptions
        and sum(res.preempts for res in rep.results) == rep.preemptions,
        "no_leaked_blocks": rep.leaked_blocks == 0,
        "prefill_per_step": rep.max_prefill_per_step <= CHUNK + reprefill,
        "cost_shares": cost_shares_sum(rep),
        "k2_launches": n["K2"] == L * rep.steps
        and n["K2 on int8 pools"] == (L * rep.steps if cfg.kv_quant else 0),
        "k1_launches": k1_ok,
        "no_other_kernel": n["K3"] == n["K4"] == 0,
    }
    info = {"prefill_pieces": base, "reprefill_tokens": reprefill,
            "reprefill_pieces": extra, "expected_k1": L * base,
            "expected_k2": L * rep.steps}
    return gates, info


def phase13_logits(label, model, params, reqs, rep, rows, plain, plain_rows):
    """A chunked, preempting serve's logits against a teacher-forced pass of
    its tokens and, step by step, against the plain serve's; its greedy
    tokens against the plain serve's under the near-tie rule. Phase 6's
    limits (phase 11's for the int8 pool: the same). Returns the
    statistics and the checks that fail (name -> failed)."""
    tf = teacher_forced(label, model, params, reqs, [r.tokens for r in rep.results], rows,
                        LOGIT_TOL, LOGIT_RMS_TOL)
    al = aligned_logits(f"{label} vs plain", reqs, rep.results, plain.results, rows,
                        plain_rows)
    divs = [first_divergence(f"{label} vs plain, request {a.rid}", a.tokens, b.tokens,
                             a.prompt_len, model, params)
            for a, b in zip(rep.results, plain.results)]
    divs = [d for d in divs if d is not None]
    for d in divs:
        print(f"  divergence {d['run']}: generated step {d['step']}, plain top-2 logit "
              f"margin {d['margin']:.4g} at top logit {d['top']:.4g} (near-tie bound "
              f"{d['near_tie_bound']:.4g})", flush=True)
    failed = {"tokens": any(not d["near_tie"] for d in divs),
              "logit_max": max(tf["first_step_max"], tf["decode_max"]) > LOGIT_TOL,
              "logit_rms": tf["rms"] > LOGIT_RMS_TOL,
              "aligned_max": al["max"] > LOGIT_TOL,
              "aligned_rms": al["rms"] > ALIGNED_RMS_TOL}
    return {"teacher_forced": tf, "aligned": al, "divergences": divs}, failed


def swap_round_trip(cfg, num_blocks):
    """swap_read -> host -> swap_write on a full-width pool of random
    contents, into other block ids: every restored block equal to the
    original (torch.equal) and the slot's table row as given."""
    from repro_torch.models import kv_cache

    C, bs, slot = 576, SERVE_OPTIONS["block_size"], 2
    cache = kv_cache.paged_cache_zeros(cfg, SERVE_OPTIONS["slots"], C, bs, num_blocks,
                                       device="cuda")
    g = torch.Generator("cuda").manual_seed(13)
    for k, leaf in cache.items():
        if k == "table":
            continue
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device="cuda"))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda"))
    rng = np.random.default_rng(13)
    picked = rng.permutation(num_blocks)[:12]
    ids, new_ids, shared = picked[:5].tolist(), picked[5:10].tolist(), picked[10:].tolist()
    row = np.full((C // bs,), num_blocks, np.int32)
    row[:7] = shared + new_ids
    before = {k: v[:, ids].clone() for k, v in cache.items() if k != "table"}
    payload = kv_cache.swap_read(cache, slot, ids)
    host = all(v.device.type == "cpu" for v in payload.values())
    kv_cache.swap_write(cache, payload, slot, new_ids, row)
    equal = {k: bool(torch.equal(cache[k][:, new_ids], v)) for k, v in before.items()}
    table = bool((cache["table"][:, slot].cpu() == torch.from_numpy(row)).all())
    nbytes = sum(v.numel() * v.element_size() for v in payload.values())
    ok = host and table and all(equal.values())
    print(f"  swap round trip, {'int8' if cfg.kv_quant else 'bf16'} pool of {num_blocks} "
          f"blocks: {len(ids)} blocks ({nbytes} B, leaves {sorted(equal)}) to the host and "
          f"back into other ids: restored blocks equal {equal}, table row as given {table}",
          flush=True)
    return {"ok": ok, "blocks": len(ids), "bytes": nbytes, "equal": equal, "table": table}


def whole_vs_chunked_prefill(model, params, n=2048, chunk=256):
    """Information only: a prompt of ``n`` tokens prefilled whole and in
    ``chunk``-token prefill_tail pieces (contiguous layout, slot_prefix_view
    / slot_scatter): the share of committed K/V bytes that are equal, the
    largest difference, and the last logits' largest difference. cuBLAS may
    reduce other row counts in another order, so bitwise equality (which
    the CPU tests hold) is not asked of the card."""
    from repro_torch.models import kv_cache

    cfg = model.cfg
    g = torch.Generator("cuda").manual_seed(n)
    x = torch.randint(0, cfg.vocab, (1, n), generator=g, device="cuda")
    logits_w, whole = model.prefill(params, {"tokens": x}, cache_len=n)
    committed = kv_cache.cache_zeros(cfg, 1, n, device="cuda")
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        if c0 == 0:
            logits, piece = model.prefill(params, {"tokens": x[:, :c1]}, cache_len=n)
        else:
            prefix = kv_cache.slot_prefix_view(committed, 0, c0)
            logits, piece = model.prefill_tail(params, {"tokens": x[:, c0:c1]}, prefix, c0)
        kv_cache.slot_scatter(committed, piece, 0, c0, 0, c1 - c0)
    same = total = 0
    diff = {}
    for k in whole:
        a, b = whole[k].contiguous(), committed[k].contiguous()
        same += int((a.view(torch.uint8) == b.view(torch.uint8)).sum())
        total += a.numel() * a.element_size()
        diff[k] = float((a.float() - b.float()).abs().max())
    logit_diff = float((logits[:, -1].float() - logits_w[:, -1].float()).abs().max())
    out = {"tokens": n, "chunk": chunk, "equal_byte_share": same / total,
           "max_abs_diff": diff, "last_logits_max_abs_diff": logit_diff}
    print(f"  whole vs chunked prefill ({'int8' if cfg.kv_quant else 'bf16'} K/V, {n} tokens, "
          f"{chunk}-token prefill_tail chunks; information): {same / total:.6f} of committed "
          f"K/V bytes equal, largest difference {diff}, last logits {logit_diff:.4g}",
          flush=True)
    return out


def serve_timing(eng, reqs, runs):
    """Warm serves timed on the host clock, in the order of ``runs``
    ((label, options) pairs): per label, ms per step (prefills included) of
    each run, the most prompt tokens prefilled in a step, and the time
    between tokens over every emission of its runs."""
    import dataclasses

    reps = {}
    for label, opts in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.serve(reqs, dataclasses.replace(opts, report_cost=False))
        torch.cuda.synchronize()
        reps.setdefault(label, []).append((time.perf_counter() - t0, rep))
    out = {}
    for label, rs in reps.items():
        results = [r for _, rep in rs for r in rep.results]
        t = {"ms_per_step": [wall * 1e3 / rep.steps for wall, rep in rs],
             "steps": rs[0][1].steps,
             "max_prompt_tokens_per_step": rs[0][1].max_prefill_per_step}
        # a preempted request's gap while swapped out is a TBT too: read the
        # requests never preempted apart
        for key, sel in (("tbt", results),
                         ("tbt_never_preempted", [r for r in results if not r.preempts])):
            tbt = np.concatenate([np.asarray(r.tbt_s) for r in sel]) * 1e3
            t.update({f"{key}_p50_ms": float(np.percentile(tbt, 50)),
                      f"{key}_p99_ms": float(np.percentile(tbt, 99)),
                      f"{key}_max_ms": float(tbt.max())})
        gaps = [max(r.tbt_s) * 1e3 for r in results if r.preempts]
        t["preempted_longest_gap_ms"] = max(gaps) if gaps else None
        out[label] = t
    return out


def phase13_chunked_preempt():
    """Full-width olmo-1b through Engine.serve with chunked prefill and
    priority preemption (phase 13), from the bf16 and the int8 pool, each
    against phase 6's plain serve of the same trace from the same pool."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    t_phase = time.perf_counter()
    reqs = phase13_trace()
    opts, plain_opts = phase13_options(reqs), phase13_options(reqs, chunked=False)
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    params = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    print(f"chunked prefill and preemption: {cfg.name} full width, bf16 seeded weights, "
          f"softmax int_pallas; phase 6's trace of {len(reqs)} requests, "
          f"{sum(r.priority == 0 for r in reqs)} in class 0 and "
          f"{sum(r.priority == 1 for r in reqs)} in class 1; phase 6's options plus "
          f"prefill_chunk {CHUNK} and preemption, pool of {opts.num_blocks} blocks "
          f"({POOL_REQUESTS} requests' worst case; phase 6's pool: "
          f"{SERVE_OPTIONS['slots'] + 1} requests' worst case)", flush=True)
    out = {"pool_blocks": opts.num_blocks, "chunk": CHUNK, "runs": {}}
    for kv_quant in (False, True):
        pool = "int8 (absmax)" if kv_quant else "bf16"
        model = Model(dataclasses.replace(cfg, kv_quant=kv_quant))
        rt = swap_round_trip(model.cfg, opts.num_blocks)
        check(rt["ok"], f"swap round trip on the {pool} pool: {rt}")
        rec = _LogitRecorder()
        eng = Engine(model, params, max_new=64, sampler=rec)
        rep, n, rows, first_s = counted_serve(eng, reqs, opts, rec)
        plain, n_p, rows_p, _ = counted_serve(eng, reqs, plain_opts, rec)
        gates, info = phase13_gates(model.cfg, reqs, rep, n)
        print(f"{pool} pool, chunked + preempting serve: {rep.steps} steps, preemptions "
              f"{rep.preemptions}, resumes {rep.resumes}, preempts per request "
              f"{[r.preempts for r in rep.results if r.preempts]}, leaked blocks "
              f"{rep.leaked_blocks}, evictions {rep.evictions}, max prompt tokens in a step "
              f"{rep.max_prefill_per_step} (chunk {CHUNK}; re-prefilled tokens "
              f"{info['reprefill_tokens']}), prefill {rep.prefill_tokens} + shared "
              f"{rep.shared_prefill_tokens} tokens; launches {n} (expected K2 "
              f"{info['expected_k2']} = {cfg.n_layers} x {rep.steps} steps, K1 "
              f"{cfg.n_layers} x ({info['prefill_pieces']} pieces + "
              f"{info['reprefill_pieces']} re-prefills)); first serve {first_s:.1f} s",
              flush=True)
        print(f"  plain serve (phase 6's options): {plain.steps} steps, max prompt tokens in "
              f"a step {plain.max_prefill_per_step}, launches {n_p}", flush=True)
        print(f"  gates: {gates}", flush=True)
        for name, ok in gates.items():
            check(ok, f"phase 13, {pool} pool: gate {name} fails ({info}, launches {n})")
        stats, failed = phase13_logits(f"chunked + preempting serve, {pool} pool", model,
                                       params, reqs, rep, rows, plain, rows_p)
        check(not any(failed.values()), f"phase 13, {pool} pool: logit or token checks "
              f"fail: {[k for k, v in failed.items() if v]}")
        run = {"gates": gates, **info, "launches": n, "plain_launches": n_p,
               "steps": rep.steps, "preemptions": rep.preemptions, "resumes": rep.resumes,
               "evictions": rep.evictions, "max_prefill_per_step": rep.max_prefill_per_step,
               "plain_max_prefill_per_step": plain.max_prefill_per_step,
               "swap_round_trip": rt, **stats}
        # 2048 tokens in 256-token chunks, and this phase's own 128-token
        # chunks of a 512-token prompt
        run["whole_vs_chunked_prefill"] = [whole_vs_chunked_prefill(model, params),
                                           whole_vs_chunked_prefill(model, params, 512, 128)]
        if not kv_quant:
            eng_t = Engine(model, params, max_new=64)
            run["timing"] = serve_timing(eng_t, reqs, [
                ("plain", plain_opts), ("chunked", opts), ("chunked", opts),
                ("plain", plain_opts)])
            card = card_line()
            for label, t in run["timing"].items():
                gap = ("" if t["preempted_longest_gap_ms"] is None else
                       f"; a preempted request's longest gap {t['preempted_longest_gap_ms']:.2f}"
                       " ms")
                print(f"  {label} serve, 2 warm runs in turns (plain, chunked, chunked, plain), "
                      f"{pool} pool: {[round(x, 2) for x in t['ms_per_step']]} ms per step "
                      f"({t['steps']} steps, prefills included), max prompt tokens in a step "
                      f"{t['max_prompt_tokens_per_step']}, time between tokens p50 "
                      f"{t['tbt_p50_ms']:.2f} / p99 {t['tbt_p99_ms']:.2f} / max "
                      f"{t['tbt_max_ms']:.2f} ms over all requests of both runs, p50 "
                      f"{t['tbt_never_preempted_p50_ms']:.2f} / p99 "
                      f"{t['tbt_never_preempted_p99_ms']:.2f} / max "
                      f"{t['tbt_never_preempted_max_ms']:.2f} ms over those never preempted"
                      f"{gap} ({card})", flush=True)
        out["runs"][pool] = run
        del eng, rec, rows, rows_p
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13 in {out['seconds']:.1f} s ({card_line()})", flush=True)
    return out


def _bf16_score_add(q_lat, q_rope, c_kv, k_rope, scale):
    # the two products added in bf16 before the cast: the "semi" error
    s1 = torch.einsum("bqhr,blr->bhql", q_lat, c_kv)
    s2 = torch.einsum("bqhd,bld->bhql", q_rope, k_rope)
    return (s1 + s2).to(torch.float32) * scale


def _rope_dropped(q_lat, q_rope, c_kv, k_rope, scale):
    return torch.einsum("bqhr,blr->bhql", q_lat, c_kv).to(torch.float32) * scale


def _current_key_masked(l_max, cache_pos, window=0, device=None):
    kv_pos = torch.arange(l_max, dtype=torch.int32, device=device)[None, :]
    return kv_pos < (cache_pos if isinstance(cache_pos, int) else cache_pos[:, None])


# Known faults of the absorbed MLA decode, patched into the gather path
# (kernel="jnp") for one serve each: (module attribute, replacement).
MLA_FAULTS = {
    "scores added in bf16": ("mla_scores", _bf16_score_add),
    "rope term dropped": ("mla_scores", _rope_dropped),
    "current key masked": ("valid_upto", _current_key_masked),
}


def fault_control():
    """The MLA serve path's end-to-end checks against known faults: serve the
    phase-8 trace cleanly (kernel="pallas", K4, and kernel="jnp") and once
    per fault in MLA_FAULTS, and read each run's teacher-forced logit
    error, its logits step by step and its greedy divergences against the
    clean pallas run, with phase 8's limits. Fails if a clean run does not
    pass; prints which checks catch each fault."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models import mla
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    reqs = _mla_trace()
    opts = ServeOptions(slots=MLA_SLOTS, paged=True, block_size=MLA_BS, prefix_share=True,
                        kernel="pallas", report_cost=False)
    model = Model(get_config("minicpm3-4b", softmax=SoftmaxSpec("int_pallas")))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=32, sampler=rec)
    clean = eng.serve(reqs, opts)
    runs = [("clean, kernel=pallas", clean, rec.rows)]
    rec.rows = {}
    runs.append(("clean, kernel=jnp", eng.serve(reqs, dataclasses.replace(opts, kernel="jnp")),
                 rec.rows))
    for fault, (attr, fn) in MLA_FAULTS.items():
        rec.rows = {}
        saved = getattr(mla, attr)
        setattr(mla, attr, fn)
        try:
            rep = eng.serve(reqs, dataclasses.replace(opts, kernel="jnp"))
        finally:
            setattr(mla, attr, saved)
        runs.append((f"{fault}, kernel=jnp", rep, rec.rows))
    results = []
    for label, rep, rows in runs:
        tf = teacher_forced(label, model, params, reqs, [r.tokens for r in rep.results], rows,
                            MLA_LOGIT_TOL, MLA_LOGIT_RMS_TOL)
        divs = [first_divergence(label, a.tokens, b.tokens, a.prompt_len, model, params)
                for a, b in zip(rep.results, clean.results)]
        divs = [d for d in divs if d is not None]
        caught = {"logit_max": max(tf["first_step_max"], tf["decode_max"]) > MLA_LOGIT_TOL,
                  "logit_rms": tf["rms"] > MLA_LOGIT_RMS_TOL,
                  "tokens": any(not d["near_tie"] for d in divs)}
        al = aligned_logits(f"{label} vs clean pallas", reqs, rep.results, clean.results,
                            rows, runs[0][2])
        caught.update(aligned_max=al["max"] > MLA_ALIGNED_TOL,
                      aligned_rms=al["rms"] > MLA_ALIGNED_RMS_TOL)
        results.append({**tf, "aligned_max": al["max"], "aligned_rms": al["rms"],
                        "diverged": len(divs),
                         "beyond_near_tie": sum(not d["near_tie"] for d in divs),
                         "caught_by": [k for k, v in caught.items() if v]})
        print(f"  {label}: {len(divs)} of {len(reqs)} requests diverge from the clean run, "
              f"{results[-1]['beyond_near_tie']} beyond a near tie; caught by "
              f"{results[-1]['caught_by'] or 'nothing'}", flush=True)
    for r in results[:2]:
        check(not r["caught_by"], f"a clean run fails a check: {r}")
    return results


def _swap_reversed(swap_write):
    def reversed_order(cache, payload, slot, ids, table_row):
        return swap_write(cache, payload, slot, list(ids)[::-1], table_row)
    return reversed_order


def _chunk_one_late(paged_scatter):
    """A commit of positions [c0, c1) with c0 > 0 (a chunk or a tail) lands
    at [c0 + 1, c1 + 1)."""
    def late(cache, values, slot, table_row, pb, offs, t0, t1):
        row = np.asarray(table_row)
        bs = next(v for k, v in cache.items() if k != "table").shape[2]
        logical = {int(b): i for i, b in enumerate(row)}
        wpos = np.asarray([logical[int(b)] * bs + int(o) for b, o in zip(pb, offs)])
        if wpos.size and wpos[0] > 0:
            wpos = wpos + 1
            pb, offs = row[np.minimum(wpos // bs, len(row) - 1)], wpos % bs
        return paged_scatter(cache, values, slot, table_row, pb, offs, t0, t1)
    return late


# Known faults of the chunk and swap path, patched into kv_cache for a run:
# (attribute, wrapper of the original).
PHASE13_FAULTS = {
    "swap_write restores the private blocks in reversed order": ("swap_write",
                                                                  _swap_reversed),
    "a chunk commits one position late": ("paged_scatter", _chunk_one_late),
}


def phase13_fault_control():
    """Phase 13's checks against known faults of the chunk and swap path:
    the phase-13 trace (bf16 pool) served cleanly and once per fault in
    PHASE13_FAULTS, each run's teacher-forced and step-aligned logits and
    greedy tokens read against the plain serve with phase 6's limits, and
    the swap round trip. On this trace every victim holds one private block
    when it is swapped out, where a reversed restore changes nothing, so a
    second, targeted trace (two class-1 requests, then a class-0 one at step
    40 on two slots, slower aging: the victim holds three) is served the
    same way. Fails
    if a clean run fails a check; prints which checks catch each fault."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models import kv_cache
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    reqs = phase13_trace()
    opts, plain_opts = phase13_options(reqs), phase13_options(reqs, chunked=False)
    targeted = [dataclasses.replace(reqs[1], arrival=0.0, max_new=64),
                dataclasses.replace(reqs[2], arrival=0.0, max_new=64),
                dataclasses.replace(reqs[4], arrival=40.0)]
    # aging 256: with the default 16 a victim that arrived more than 16 steps
    # before the class-0 request outranks it once swapped out, swaps straight
    # back in and is preempted again, forever (the reference's serve does
    # the same: ROADMAP.md Queue 3), so the default keeps victims under 17
    # generated tokens, one private block
    t_opts = dataclasses.replace(opts, slots=2, aging=256.0, report_cost=False)
    model = Model(get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas")))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=64, sampler=rec)
    plain, _, plain_rows, _ = counted_serve(eng, reqs, plain_opts, rec)
    t_plain, _, t_plain_rows, _ = counted_serve(
        eng, targeted, dataclasses.replace(t_opts, preemption=False), rec)
    victims = []
    swap_read = kv_cache.swap_read

    def counting_read(cache, slot, ids):
        victims.append(len(ids))
        return swap_read(cache, slot, ids)

    results = []
    for fault in [None] + list(PHASE13_FAULTS):
        label = fault or "clean"
        saved = None
        if fault is not None:
            attr, wrap = PHASE13_FAULTS[fault]
            saved = getattr(kv_cache, attr)
            setattr(kv_cache, attr, wrap(saved))
        kv_cache.swap_read = counting_read
        try:
            caught = {"round_trip": not swap_round_trip(model.cfg, opts.num_blocks)["ok"]}
            victims.clear()
            rep, _, rows, _ = counted_serve(eng, reqs, opts, rec)
            held = list(victims)
            _, failed = phase13_logits(f"{label}, phase 13 trace", model, params, reqs, rep,
                                       rows, plain, plain_rows)
            caught.update({f"{k} (trace)": v for k, v in failed.items()})
            victims.clear()
            rep_t, _, rows_t, _ = counted_serve(eng, targeted, t_opts, rec)
            held_t = list(victims)
            _, failed = phase13_logits(f"{label}, targeted trace", model, params, targeted,
                                       rep_t, rows_t, t_plain, t_plain_rows)
            caught.update({f"{k} (targeted)": v for k, v in failed.items()})
        finally:
            kv_cache.swap_read = swap_read
            if saved is not None:
                setattr(kv_cache, attr, saved)
        results.append({"run": label, "victims_private_blocks": held,
                        "targeted_victims_private_blocks": held_t,
                        "preemptions": rep.preemptions,
                        "targeted_preemptions": rep_t.preemptions,
                        "caught_by": [k for k, v in caught.items() if v]})
        print(f"  phase 13, {label}: victims' private blocks {held} (targeted trace "
              f"{held_t}); caught by {results[-1]['caught_by'] or 'nothing'}", flush=True)
    check(not results[0]["caught_by"], f"a clean phase-13 run fails a check: {results[0]}")
    clean = results[0]
    check(clean["targeted_preemptions"] >= 1 and all(
        b >= 2 for b in clean["targeted_victims_private_blocks"]),
        f"the targeted trace's victims hold fewer than two private blocks: {clean}")
    return results


def _own_chunk_max(chunk_max):
    return chunk_max


def _last_partial_dropped(partials):
    acc = torch.zeros_like(partials[0])
    for part in partials[:-1]:
        acc = acc + part
    return acc


# Known faults of K2's and K4's split, patched into their plain split
# versions (kernels/paged_attention/ref.py, chunk_pages set): (module
# attribute, replacement).
SPLIT_FAULTS = {
    "each chunk quantizes against its own max": ("split_row_max", _own_chunk_max),
    "one chunk's PV partial dropped": ("combine_partials", _last_partial_dropped),
}


def _last_sum_dropped(chunk_sums):
    return chunk_sums[..., :-1].sum(-1)


# Known faults of K1's split, patched into its plain split version
# (kernels/int_softmax/ref.py:int_softmax_split_ref): (module attribute,
# replacement).
K1_SPLIT_FAULTS = {
    "each chunk quantizes against its own max": ("split_row_max", _own_chunk_max),
    "one chunk's sum dropped": ("split_row_sum", _last_sum_dropped),
}


def k1_fault_control():
    """K1's check (phase 3's bitwise comparison with the whole-row plain
    version) against known faults of the split: the plain split version
    at the 8 x 32768 shape and the kernel's chunks, cleanly and once per
    fault in K1_SPLIT_FAULTS, stands in for the kernel. Fails if the clean
    run fails the check or a fault passes it; prints what each changes."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.int_softmax import ops, ref

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((8, 32768), generator=gen, device="cuda") * 3.0
    mask = (torch.rand((8, 32768), generator=gen, device="cuda") < 0.7).to(torch.uint8)
    plan = ops.launch_plan(x)
    want = ref.int_softmax_ref(x, BEST, mask)
    kernel = ops.int_softmax_rows(x, BEST, mask)
    results = {}
    for fault, (attr, fn) in [("clean", (None, None))] + list(K1_SPLIT_FAULTS.items()):
        saved = getattr(ref, attr) if attr else None
        if attr:
            setattr(ref, attr, fn)
        try:
            got = ref.int_softmax_split_ref(x, BEST, mask, plan.chunk_cols)
        finally:
            if attr:
                setattr(ref, attr, saved)
        differ = int((got != want).sum())
        results[fault] = {"caught_by": ["k1_bitwise"] if differ else [],
                          "elements_differing": differ,
                          "max_abs_err": float((got - want).abs().max())}
        print(f"  K1 split ({k1_layout(plan, 8)}), {fault}: caught by "
              f"{results[fault]['caught_by'] or 'nothing'}; {differ} of {x.numel()} "
              f"probabilities differ", flush=True)
    check(torch.equal(kernel, want), "K1 differs from its plain version")
    check(not results["clean"]["caught_by"], f"the clean K1 split fails: {results}")
    for fault in K1_SPLIT_FAULTS:
        check(results[fault]["caught_by"], f"K1: the bitwise check misses {fault!r}")
    return results


def k2_fault_control():
    """K2's checks (phase 5's k2_checks) against known faults of the split:
    the plain split version at the serve decode shape, cleanly and once per
    fault in SPLIT_FAULTS, stands in for the kernel. Fails if the clean run
    fails a check or a fault passes them; prints which checks catch each."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.paged_attention import ref

    gen = torch.Generator("cuda").manual_seed(0)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    S, KV, BS, NLOG = 8, 16, 16, 36
    q, k, v, table, pos = _k2_inputs(gen, S=S, KV=KV, group=1, T=1, D=128, BS=BS, NLOG=NLOG,
                                     NB=324, dtype=torch.bfloat16,
                                     qpos=np.random.default_rng(1).integers(400, 576, size=8))
    kw = dict(scale=128 ** -0.5, window=0, scores_dtype=torch.float32)
    want = ref.paged_attention_ref(q, k, v, table, pos, BEST, return_rows=True, **kw)
    cp, chunks = k2_key_chunks(table, pos, KV=KV, rows=1, BS=BS, window=0)
    results = {}
    for fault, (attr, fn) in [("clean", (None, None))] + list(SPLIT_FAULTS.items()):
        saved = getattr(ref, attr) if attr else None
        if attr:
            setattr(ref, attr, fn)
        try:
            x = ref.paged_attention_ref(q, k, v, table, pos, BEST, return_rows=True,
                                        chunk_pages=cp, **kw)
        finally:
            if attr:
                setattr(ref, attr, saved)
        res = k2_checks(x, q=q, k=k, v=v, table=table, pos=pos, kw=kw, group=1,
                        chunks=chunks, want=want[0], want_sc=want[1], want_pr=want[2])
        units = {**res["score_bound_units"], **{f"out_{n}": u for n, u in
                                                 res["output_bound_units"].items()}}
        caught = (["alg1_bitwise"] if not res["alg1_bitwise"] else []) + [
            n for n, u in units.items() if n != "plain_vs_exact" and u > 1]
        results[fault] = {"caught_by": caught, "bound_units": units}
        print(f"  K2 split, {fault}: caught by {caught or 'nothing'}; in units of the "
              f"bounds {units}", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    check(not results["clean"]["caught_by"], f"the clean split fails a check: {results}")
    own, drop = (results[f] for f in SPLIT_FAULTS)
    check("alg1_bitwise" in own["caught_by"],
          "the bitwise Alg.-1 check misses per-chunk maxima")
    check(drop["bound_units"]["out_pv_vs_exact"] > 100,
          "the PV bound misses a dropped chunk partial by less than 100x")
    return results


def k4_fault_control():
    """K4's checks (phase 7's k4_checks) against the known faults of the
    split: the plain split version at the MLA serve decode shape and K4's
    chunk size, cleanly and once per fault in SPLIT_FAULTS, stands in for
    the kernel. Fails if the clean run fails a check or a fault passes
    them; prints which checks catch each."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.paged_attention import ref

    gen = torch.Generator("cuda").manual_seed(0)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    nlog = -(-max(r.prompt_len + r.max_new for r in _mla_trace()) // MLA_BS)
    qpos = np.random.default_rng(1).integers(400, nlog * MLA_BS, size=MLA_SLOTS)
    q_lat, q_rope, c, kr, table, pos = _k4_inputs(
        gen, np.random.default_rng(2), S=MLA_SLOTS, H=40, T=1, R=256, DR=32, BS=MLA_BS,
        NLOG=nlog, NB=(MLA_SLOTS + 1) * nlog, dtype=torch.bfloat16, qpos=qpos, parked=(),
        mixed=False)
    args, scale = (q_lat, q_rope, c, kr, table, pos, BEST), 96 ** -0.5
    want = ref.paged_attention_mla_ref(*args, scale=scale, return_rows=True)
    cp, chunks = k4_key_chunks(table, pos, rows=40, BS=MLA_BS)
    results = {}
    for fault, (attr, fn) in [("clean", (None, None))] + list(SPLIT_FAULTS.items()):
        saved = getattr(ref, attr) if attr else None
        if attr:
            setattr(ref, attr, fn)
        try:
            x = ref.paged_attention_mla_ref(*args, scale=scale, chunk_pages=cp,
                                            return_rows=True)
        finally:
            if attr:
                setattr(ref, attr, saved)
        res = k4_checks(x, q_lat=q_lat, q_rope=q_rope, c=c, kr=kr, table=table, pos=pos,
                        scale=scale, chunks=chunks, want=want[0], want_sc=want[1],
                        want_pr=want[2])
        units = {**res["score_bound_units"], **{f"out_{n}": u for n, u in
                                                 res["output_bound_units"].items()}}
        caught = (["alg1_bitwise"] if not res["alg1_bitwise"] else []) + [
            n for n, u in units.items() if n != "plain_vs_exact" and u > 1]
        if res["score_share_differing"]["vs_exact"] > 0.01:
            caught.append("score_share")
        results[fault] = {"caught_by": caught, "bound_units": units}
        print(f"  K4 split (chunks of {cp} pages), {fault}: caught by {caught or 'nothing'}; "
              f"in units of the bounds {units}", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    check(not results["clean"]["caught_by"], f"the clean K4 split fails a check: {results}")
    own, drop = (results[f] for f in SPLIT_FAULTS)
    check("alg1_bitwise" in own["caught_by"],
          "K4: the bitwise Alg.-1 check misses per-chunk maxima")
    check(drop["bound_units"]["out_pv_vs_exact"] > 100,
          "K4: the PV bound misses a dropped chunk partial by less than 100x")
    return results


def _bf16_rounded(scores_fn):
    return lambda q, k: scores_fn(q, k).to(torch.bfloat16).float()


def k3_fault_control():
    """K3's checks (phase 12's k3_checks) against known faults of its
    passes: the plain tiled version (``ref.int_attention_tiled``) at
    olmo-1b's prefill shape over the bf16 kernel's tiles, cleanly and with
    each key tile quantizing against its own max, with one key tile's PV
    dropped and with its scores rounded to bf16, stands in for the kernel.
    Fails if the clean run fails a check or a fault passes them; prints
    which checks catch each."""
    from repro_torch.core.precision import BEST
    from repro_torch.kernels.int_attention import ref
    from repro_torch.kernels.int_softmax import ref as k1_ref

    gen = torch.Generator("cuda").manual_seed(102)
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    B, H, S, D = 4, 16, 512, 128
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=True, window=0)
    want = ref.int_attention_ref(q, k, v, BEST, return_rows=True, **kw)
    faults = {  # (module, attribute, replacement from the original)
        "each key tile quantizes against its own max": (
            k1_ref, "split_row_max", lambda f: _own_chunk_max),
        "one key tile's PV dropped": (ref, "combine_partials", lambda f: _last_partial_dropped),
        "scores rounded to bf16": (ref, "attention_scores", _bf16_rounded),
    }
    rows = lambda x: x.reshape(B * H, S, D)  # noqa: E731
    tiles = ref.k3_tiles(torch.bfloat16, D, B * H, S,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    results = {}
    for fault, (mod, attr, make) in [("clean", (None, None, None))] + list(faults.items()):
        saved = getattr(mod, attr) if mod else None
        if mod:
            setattr(mod, attr, make(saved))
        try:
            out, sc, pr = ref.int_attention_tiled(q, k, v, BEST, q_tile=tiles[0],
                                                  k_tile=tiles[1], return_rows=True, **kw)
        finally:
            if mod:
                setattr(mod, attr, saved)
        res = k3_checks((rows(out), sc, pr), q=rows(q), k=rows(k), v=rows(v), cfg=BEST,
                        want=rows(want[0]), want_sc=want[1], want_pr=want[2], **kw)
        units = {**res["score_bound_units"], **{f"out_{n}": u for n, u in
                                                 res["output_bound_units"].items()}}
        caught = (["alg1_bitwise"] if not res["alg1_bitwise"] else []) + [
            n for n, u in units.items() if n != "plain_vs_exact" and u > 1]
        share = res["score_share_differing"]["beyond_quarter_bf16_ulp"]
        if share > 0.01:
            caught.append("score_share")
        results[fault] = {"caught_by": caught, "bound_units": units, "score_share": share}
        print(f"  K3 tiled (q tile {tiles[0]}, key tile {tiles[1]}), {fault}: caught by "
              f"{caught or 'nothing'}; in units of the bounds {units}; share beyond a "
              f"quarter bf16 ulp {share:.4%}", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    check(not results["clean"]["caught_by"], f"the clean K3 tiled version fails: {results}")
    own, drop, bf16 = (results[f] for f in faults)
    check("alg1_bitwise" in own["caught_by"],
          "K3: the bitwise Alg.-1 check misses per-tile maxima")
    check(drop["bound_units"]["out_pv_vs_exact"] > 100,
          "K3: the PV bound misses a dropped key tile by less than 100x")
    check("score_share" in bf16["caught_by"], "K3: the score share misses bf16 scores")
    return results


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main():
    fault_mode = sys.argv[1:] == ["--fault-control"]
    if sys.argv[1:] and not fault_mode:
        raise SystemExit("usage: python3 chip_smoke.py [--fault-control]")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # f32 products in full f32 (no TF32) for the card-vs-CPU comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    # phase 1: environment
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc}", flush=True)
    print(card, flush=True)
    rate = hbm_rate(name)

    if fault_mode:
        build.build(["int_softmax", "paged_attention", "paged_attention_mla"])
        t0 = time.perf_counter()
        k1_results = k1_fault_control()
        k2_results = k2_fault_control()
        k4_results = k4_fault_control()
        k3_results = k3_fault_control()
        results = fault_control()
        p13_results = phase13_fault_control()
        print(f"fault control: {time.perf_counter() - t0:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"k1_fault_control": k1_results, "k2_fault_control": k2_results,
                          "k4_fault_control": k4_results, "k3_fault_control": k3_results,
                          "fault_control": results, "phase13_fault_control": p13_results}),
              flush=True)
        return

    # phase 2: build every kernel of the paths, all nvcc processes at once
    t0 = time.perf_counter()
    logs = build.build(["int_softmax", "paged_attention", "paged_attention_mla",
                        "int_attention"])
    print(f"build: {sorted(logs) or 'already built'} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    t_all = time.perf_counter()
    recs = timed("phase 3 (K1 against its plain version)", phase3_k1, rate)
    launches = timed("phase 4 (generate path)", phase4_main_path)
    k2_recs = timed("phase 5 (K2 against its plain version)", phase5_k2, rate)
    served = timed("phase 6 (serve path, olmo-1b)", phase6_serve)
    k4_recs = timed("phase 7 (K4 against its plain version)", phase7_k4, rate)
    mla = timed("phase 8 (serve path, minicpm3-4b)", phase8_mla_serve)
    k2_int8_recs = timed("phase 9 (K2's int8 branch against its plain version)",
                         phase9_k2_int8, rate)
    quantize = timed("phase 10 (kv_quantize, card vs CPU)", phase10_kv_quantize)
    served_int8 = timed("phase 11 (serve path, olmo-1b, int8 KV pool)", phase6_serve, True)
    k3_recs, k3_launches = timed("phase 12 (K3 against its plain version; its path)",
                                 phase12_k3, rate)
    chunked = timed("phase 13 (chunked prefill and preemption, olmo-1b, bf16 and int8 pools)",
                    phase13_chunked_preempt)
    print(f"phases 3-13: {time.perf_counter() - t_all:.1f} s", flush=True)

    # phase 14
    main_rec = next(r for r in recs if r["shape"] == "prefill (main path)")
    k2_main = next(r for r in k2_recs if r["shape"] == "decode (main path)")
    k2_int8_main = next(r for r in k2_int8_recs if r["shape"] == "int8 decode (main path)")
    k3_main = next(r for r in k3_recs if r["shape"] == "olmo-1b prefill (main)")
    k4_main = next(r for r in k4_recs if r["shape"] == "decode (main path)")
    k1_by_path = {"generate": launches, "serve olmo-1b": served["launches"]["K1"],
                  "serve minicpm3-4b": mla["launches"]["K1"],
                  "serve olmo-1b int8": served_int8["launches"]["K1"]}
    kernels = [{
        "name": "int_softmax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int_softmax.cu",
        "replaces": "src/repro/kernels/int_softmax/kernel.py:43",
        "design": "one launch of ref.k1_split_plan's layout: a warp a row with the row in "
                  "registers up to 2048 columns; longer rows over a thread-block cluster "
                  "in exact Alg.-1 passes (chunk maxima, int64 chunk sums through "
                  "distributed shared memory); exp by a table, division by a reciprocal "
                  "per row",
        "launches": sum(k1_by_path.values()), "launches_by_path": k1_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg. 1
        "shapes": recs,
    }, {
        "name": "paged_attention_dense", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:145",
        "launches": served["launches"]["K2"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_recs),
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg. 1 attention
        "shapes": k2_recs,
    }, {
        "name": "paged_attention_dense (int8 pools)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:145",
        "launches": served_int8["launches"]["K2 on int8 pools"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_int8_recs),
        "ms": k2_int8_main["ms"], "plain_ms": k2_int8_main["plain_ms"],
        "bound_ms": k2_int8_main["bound_ms"], "bound_by": k2_int8_main["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg. 1 attention
        "shapes": k2_int8_recs,
    }, {
        "name": "int_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int_attention.cu",
        "replaces": "src/repro/kernels/int_attention/kernel.py:63",
        "design": "one CTA per (head, query tile of ref.k3_tiles) over the key tiles of "
                  "ref.k3_plan in three exact Alg.-1 passes (row max, int64 sums, "
                  "probabilities and PV) that recompute QK^T; bf16 up to d 128: QK^T on "
                  "wgmma (Q in registers), PV on mma.sync with P repacked in registers, "
                  "Q/K/V tiles by TMA; exp by a table, a branch-free division by S, a "
                  "reciprocal per row; no cap on context",
        "q_tile": k3_main["q_tile"], "k_tile": k3_main["k_tile"],
        "launches": k3_launches,   # its stand-alone path; 0 on the serve paths
        "launches_on_serve_paths": served["launches"]["K3"] + mla["launches"]["K3"]
        + served_int8["launches"]["K3"],
        "max_abs_err": max(r["max_abs_err"] for r in k3_recs),
        "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg. 1 attention
        "shapes": k3_recs,
    }, {
        "name": "paged_attention_mla", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_mla.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:248",
        "design": "rows split over CTAs in exact Alg.-1 passes (scores and chunk maxima, "
                  "integer sums, PV partials added in chunk order); bf16 dots and PV on "
                  "tensor cores (mma.sync m16n8k16, f32 accumulate)",
        "chunk_pages": k4_main["chunk_pages"],
        "chunk_keys": k4_main["chunk_pages"] * k4_main["BS"],
        "launches": mla["launches"]["K4"],
        "max_abs_err": max(r["max_abs_err"] for r in k4_recs),
        "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg.-1 attention
        "shapes": k4_recs,
    }]
    print(json.dumps({"serve": {"olmo-1b": served, "minicpm3-4b": mla,
                                "olmo-1b int8": served_int8,
                                "olmo-1b chunked + preempting": chunked},
                      "kv_quantize_card_vs_cpu": quantize}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
