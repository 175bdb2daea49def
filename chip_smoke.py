"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: every CUDA kernel of the main path, from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` a source, all started together; phases 3 and 4 (K1 alone)
   run while K2-K4 finish;
3. K1 (the Alg.-1 softmax kernel) against its plain PyTorch version, bitwise,
   at the generate and serve paths' shapes (whisper-base's unmasked
   1500-column encoder and cross-attention rows and qwen2-vl-7b's prefill
   and decode rows among them) and at edge shapes (odd
   widths, sentinel rows, a saturating sum, M=15 (no exp table), rows split
   over a cluster of CTAs up to 131072 columns, where the plain split
   version over the kernel's chunks must agree too), with the kernel's and
   the plain version's times, the card's memory bound, the launch's layout
   and the CUDA launches of one call (torch.profiler: one of that layout);
4. the main path: full-width olmo-1b (16 layers, d_model 2048, seeded random
   bf16 weights) through ``Engine.generate(mode="fused")`` with softmax
   ``int_pallas``, batch 4, prompt 512, 32 new tokens, each decode step one
   CUDA-graph replay (``serving/graphs.py``). K1 must launch exactly
   16 x 32 = 512 times, graphed and op by op (graphed: the wrappers'
   count plus the replays times the 16 K1 kernels each replay launched in
   the device trace, which is gated too); the graphed run must equal
   the op-by-op one bitwise (tokens, last logits, cache bytes) with one
   capture, dispatch at most 20 aten ops a step and take less time a step
   (printed beside op by op and mode="eager", with the fused / eager
   ratio and one replayed step's device trace: GEMMs, K1-K4 and the rest,
   and the idle share); the same model with the plain torch Alg. 1
   (``int``) must give bitwise equal tokens and last logits; then the smoke
   config on the card against the same weights on the CPU; then llama2-7b
   at full width and half depth (16 of its 32 layers, d_model 4096:
   ``LLAMA_LAYERS``) through the same graphed generate at batch 4, prompt
   512, 32 new tokens: K1 16 x 32 = 512, the same checks and times, and the
   peak memory;
5. K2 (the fused paged decode, each row split over CTAs) against its plain
   PyTorch version at the serve path's decode shape and its verify shape
   (T 5, phase 14), the reference's paged-kernel matrix and long rows
   (32768 keys; T 5, GQA 7 and 35 rows at 16384-32768; T 5 at 32768 keys
   in row groups), dbrx-132b's serve shapes (GQA 48/8 at T 1 and
   T 5), hymba-1.5b's and qwen2-vl-7b's (GQA 28/4, group 7): the plain
   Alg. 1 on K2's own scores gives its
   probabilities bitwise; a second run gives the same bits; each entry of
   a verify block (T > 1) gives the bits of a T-1 call at its position;
   scores and outputs within stated bounds (outputs: of K2's chunked
   summation tree); times and bounds as for K1;
6. the serve path: full-width olmo-1b through ``Engine.serve`` (paged pool,
   prefix sharing, ``kernel="pallas"``) on a 32-request shared-prefix
   trace. K2 must launch 16 x steps times (the replays' launches counted
   in the device trace, 16 a replay) and K1 16 x 32; greedy tokens
   equal ``kernel="jnp"`` and per-request eager but at near ties; every
   served logit within a stated limit of a teacher-forced prefill of the
   served tokens, and of the jnp serve's step by step; each decode step one
   CUDA-graph replay, bitwise equal to the same serve op by op on its first
   request (tokens, every logit row, pool bytes; the op-by-op launches
   as its steps imply), one capture per engine and step
   shape, at most 20 aten ops a replayed greedy step and less time a step
   than op by op (warm serves in turns, with the jnp kernel's graphed
   serve), one replayed step's device trace;
7. K4 (the absorbed-MLA paged decode, each row split over CTAs, both dots
   and PV on tensor cores in bf16) against its plain PyTorch version at the
   MLA serve path's decode shape, the reference's MLA kernel matrix,
   4096-token rows, parked slots, f32 compute, deepseek-v2's width at 512
   and 4096 keys, T 3 at 4096 keys, T 5 at the serve shape (200 rows,
   phase 14's verify round), a 32768-token row and deepseek-v2-236b's
   serve shapes (8 slots, H 128, R 512, DR 64 at T 1 and T 5), with the checks
   of phase 5 (verify blocks against T-1 calls bitwise too; outputs: of
   K4's chunked summation tree, bounded for
   truncating tensor-core sums) and a second run bitwise equal (and K1 at
   the MLA path's shapes in phase 3);
8. the MLA serve path: full-width minicpm3-4b (62 layers, d_model 2560, 40
   heads, latent rank 256) through ``Engine.serve`` as in phase 6 on an
   8-request shared-prefix trace: K4 must launch 62 x steps times, K1 62 x
   8 and K2 never; the checks of phase 6, graph checks and times included;
9. K2's int8 branch against its plain version: the serve decode shape with
   absmax and with power-of-two (exaq) scales, sentinels and parked slots,
   4096-token rows, f32 compute, a 32768-token row; phase 5's checks;
10. ``kv_quantize`` on the card against the CPU on the K/V of a full-width
    512-token prefill: absmax bitwise; the EXAQ schemes bitwise or one
    power of two apart (printed);
11. the serve path of phase 6 from an int8 KV pool (absmax): K2 must launch
    16 x steps times, all on int8 pools, and K1 16 x 32; the checks of
    phase 6 with the int8 limits (the teacher-forced pass quantizes K/V as
    the prefill does), phase 6's graph checks and times, the pool's bytes
    per token, and for information the logit distance to the bf16 model;
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
13. chunked prefill and priority preemption (olmo-1b at full width and 8
    of its 16 layers, ``OLMO_CUT_LAYERS``, with the ``CUT_*`` limits): phase
    6's trace with every
    fourth request in class 0 and the rest in class 1, served with phase
    6's options plus ``prefill_chunk=128`` and ``preemption=True`` from a
    pool of six requests' worst case, once from the bf16 pool and once
    from the int8 pool, each against the plain serve (phase 6's options)
    of the same trace from the same pool. Gates: preemptions >= 1 and as many resumes,
    no leaked blocks, at most 128 prompt tokens a step (beyond a resume's
    re-prefill of evicted blocks), cost shares summing to the batch meter,
    K2 16 x steps launches (on int8 pools only in the int8 run), K1 16 x
    the prefill pieces worked out from the trace, greedy tokens equal to
    the plain serve's but at near ties, served logits within phase 6's
    limits of a teacher-forced pass and, step by step, of the plain
    serve's, and the chunked serve equal to the plain one bitwise (tokens,
    every step-aligned logit row). Beside them: the swap round trip on
    each full-width pool (bitwise), a 2048-token prompt prefilled whole
    and in 256-token chunks and a 512-token one in 128-token chunks
    (committed K/V bytes and last logits bitwise equal: the prefill pads
    its products to 256 rows on the card, past cuBLAS's split-K), the
    kernels each prefill product launches at 128 and 512 rows, whether the
    pieces' rows equal the whole's plain and padded (gated) and a piece's
    time plain and padded, phase 6's graph checks and times for
    the chunked serve on each pool (bitwise equal to op by op, preemptions
    and resumes included), with the chunked and plain serves' ms per
    step, most prompt tokens in a step and time between tokens (p50, p99,
    max), with the card's name and power limit;
14. speculative serving (``ServeOptions(speculative=True)``, n-gram drafts
    of 4 tokens): phase 6's trace and options from the bf16 and the int8
    pool, olmo-1b at 8 of its 16 layers (``OLMO_CUT_LAYERS``, the ``CUT_*``
    limits). Each verify round is one CUDA-graph replay; K2 must launch 8 x
    rounds times, every call at T 5 (all on int8 pools from the int8
    pool), K1 8 x 32; greedy tokens and every served logit row bitwise
    equal to the plain serve's of that depth and pool (K2 and K4 split a verify
    block's rows at the decode step's chunks, and the decode and verify
    steps pad the down projection and the norms to one row count), every
    served logit
    row within the teacher-forced limits, the meter's shares summing to
    the batch meter and its verify and draft phases the step meters times
    the rounds; on the first request the graphed serve equals the same
    serve op by op bitwise (tokens, logit rows, pool bytes, launches), and
    after every round of the op-by-op run each slot's rejected positions
    in the pool are zero bitwise. Then (bf16) two warm speculative serves
    (ms per round, tok/s, aten ops a replayed round), the first 8 requests with ``prefill_chunk=128`` bitwise equal
    to the speculative serve's rows of them, and the first 8 requests with
    a two-layer olmo-1b draft model and with the target as its own draft
    (proposal steps graph replays through K2, launches as the rounds
    imply; the target as its own draft accepts every proposal). Then
    minicpm3-4b on phase 8's trace: K4 62 x rounds at 200 query rows and
    the same checks with phase 8's limits (op by op on 1 request); and
    phase 8's trace with every fourth request in class 0, chunked (128)
    and preempting from a pool of 110 blocks, equal to phase 8's plain
    serve bitwise (tokens, every logit row), with at least one preemption;
15. the softmax-variant zoo and the functional AP simulator (item 12): on
    the scores of olmo-1b's first prefill layer (512 tokens), ConSmax's
    integer codes on the card bitwise equal to the CPU's, each variant's
    probabilities within ``VARIANT_CARD_CPU_TOL`` of the CPU's, ap_sim's
    (a host round trip) bitwise equal to ``int``'s; then olmo-1b at full
    width and 8 of its 16 layers (``OLMO_CUT_LAYERS``; seeded bf16 weights
    through ``convert.params_from_numpy``)
    serving phase 6's trace cut to 8 requests with phase 6's options and
    ``kernel="jnp"`` under ``softmax_kind`` consmax, sole and mive: decode
    steps CUDA-graph replays, the first request graphed == op by op
    bitwise (tokens, logit rows, pool bytes), greedy tokens equal to an
    eager generate of the variant model (the first request) but at near ties,
    every logit within ``VARIANT_LOGIT_*`` of a teacher-forced pass,
    ``kernel="pallas"`` rejected, ms per step of a warm graphed serve, the
    AP meter's cycles ordered mive < sole < consmax < int; ap_sim serving
    2 requests (prompt 64, 8 new tokens) op by op (0 replays, the reason
    in the report) bitwise equal to the int serve op by op, with the same
    meter; a ConSmax model with seeded non-default beta and gamma,
    converted with its ``smx`` leaves, serving 1 request;
16. the MoE family (item 11) at full width, 4 layers, seeded bf16
    weights with the embedding at std 1 (``MOE_EMBED_STD``): (a) dbrx-132b
    (d_model 6144, 48 / 8 heads, 16 experts top-4) through the graphed
    ``Engine.generate(mode="fused")`` at batch 4, prompt 512, 32 new tokens:
    K1 4 x 32, graph == op by op == eager bitwise, ``int`` == ``int_pallas``
    bitwise, ms a step beside the weight-read bound, peak memory; (b)
    dbrx-132b serving phase 6's trace cut to 8 requests with phase 6's
    options: K2 4 x steps all at GQA group 6, K1 4 x 8, graph == op by op
    bitwise on 1 request, every served token the argmax of a teacher-forced
    pass that routes as the serve did (``moe_forced_rows``) but at near
    ties, its first rows bitwise, the logits within ``MOE_LOGIT_TOL``, and
    a control serve (K2 leaving out each sequence's first page) failing
    those checks; then speculatively (n-gram drafts of 4, K2 at T 5), op by op with every
    verify round's dropped assignments counted and graphed, graph == op by
    op bitwise on all 8, each request no drop reached bitwise equal to the
    plain serve, the others held to the forced pass's limits; (d) one dbrx
    MoE layer on 512 tokens against the port's CPU path at both embedding
    scales (expert ids over a top-k margin of 1e-3, slots and drops, the
    output within a stated bound; at std 0.02 dropped assignments among
    those compared); (c) deepseek-v2-236b (MLA at 128 heads, kv_lora 512,
    160 experts top-6, 2 shared, a dense prefix layer) serving (b)'s
    requests: K4 4 x steps at (1, 128), K2 never, (b)'s plain-serve checks
    and control (K4 leaving out the first page); expert parallelism (item
    22), every shard on cuda:0 (``tp_serve``): (e) (b)'s serve over 2 and
    4 shards (each shard's K2 at 4 / 2 kv-heads, group 6) and (f) (c)'s
    over 2 (each shard's K4 at 64 heads on the gathered latent pool), each
    held against the single-device serve at tier (b) (``MOE_TP_TOL``), its
    launches n x layers x steps, every step one replay bitwise equal to op
    by op, each shard's pool bytes ``pool_report``'s, the first request's
    routed assignments that differ printed; (g) the ``"a2a"`` dispatch:
    dbrx's MoE layer on (d)'s 512 tokens card against CPU (per-segment
    slots and drops), a2a == gather bitwise at capacity 16, a2a dropping
    more than gather at 1.0, the router's column slices' moved assignments
    printed, and an a2a serve single-device against 2 shards;
17. the recurrent families (item 11's SSM and hybrid bullets) at full
    width and a quarter depth (``REC_LAYERS``), seeded bf16 weights, prompts
    on the SSD chunk grid: (a) mamba2-780m (12 of its 48 SSD layers, no
    attention, so no kernel) and (b) hymba-1.5b (8 of its 32 layers: 3
    global on K1 / K2, 5 window layers on rings of 1024 keys) through the
    graphed ``Engine.generate(mode="fused")`` at batch 4, 256 new tokens
    after prompts of 256 and 1280: K1 0 and 8 x 256 launches, every
    decoded logit row within
    ``REC_GEN_TOL`` of ``Model.train_logits`` over the sequence, hymba's
    ring positions as the decoded positions put them, over the first 32
    steps graph == op by op bitwise (tokens, last logits, state bytes) ==
    mode="eager", hymba's ``int`` == ``int_pallas`` bitwise, ms a step
    beside the bytes bound, peak memory; (c) hymba-1.5b serving an
    8-request trace (prompts 192 and 256, 16-64 new tokens) with phase 6's
    options through phase 6's checks (``serve_phase``): nothing shared, K2
    3 x steps all at (1, 5), K1 5 x steps + 8 x 8, graph == op by op
    bitwise on 1 request, greedy tokens == jnp and eager but at near ties,
    served logits within the ``HYMBA_*`` limits of a teacher-forced pass
    and a control (K2 leaving out each sequence's first page) failing them,
    warm serves timed graphed and op by op; (d) both models on that trace
    with every fourth request in class 0, chunked (128: the staged branch) and
    preempting from a pool of 3 requests' worst case: the swap round trip
    of blocks and stripes bitwise, the serve equal to the plain serve
    bitwise (tokens, every logit row); (e) both served speculatively
    (n-gram drafts of 4), one replay a round: equal to the plain serve
    bitwise, hymba's K2 at (5, 25) 3 x rounds and K1 8 x 8 + 5 x 5 x
    rounds, acceptance and ms a round of a warm serve;
18. the encoder-decoder and M-RoPE families (item 11's last bullets) at
    full width, seeded bf16 weights: (a) whisper-base (6 encoder and 6
    decoder layers, d_model 512) serving 8 requests of 1500 encoder frames
    (Whisper's 30 s window), prompts 4-32, 32-64 new tokens, through the
    contiguous executor at 4 slots (``kernel="jnp"``, the reference's only
    encdec executor): every served stream bitwise equal to its per-request
    eager generate with the same frames (tokens, every logit row), K1 18 a
    prefill and 12 a replayed step, graph == op by op bitwise on the first
    request (tokens, logit rows, cache bytes with the cross K/V), ``int``
    == ``int_pallas`` bitwise, every served logit within the ``WHISPER_*``
    limits of a teacher-forced ``_encdec_logits`` pass, warm serves timed
    graphed and op by op, and its smoke config card vs CPU; (b)
    qwen2-vl-7b at full width and half depth (14 of its 28 layers,
    ``QWEN_LAYERS``; d_model 3584, GQA 28/4, M-RoPE sections 16 / 24 / 24,
    QKV biases drawn non-zero) through phase 4's graphed generate
    at batch 4, prompt 512, 32 new tokens (K1 14 x 32, ``int`` ==
    ``int_pallas`` bitwise), then phase 6's trace cut to 8 requests (16-32
    new tokens) served paged from the bf16 pool with ``kernel="pallas"``
    and no prefix sharing through phase 6's checks (``serve_phase``: K2 14
    x steps at (1, 7), phase 6's limits, graph == op by op on 1
    request, a control failing the limits), and a prefill whose three
    position streams differ (an image block, then text) on its smoke
    config, card against CPU;
19. training (item 13): (a) full-width, full-depth olmo-1b (1.18 B
    parameters) from f32 master weights, bf16 compute, every layer
    rematerialised, ``int``, the train launcher's AdamW at lr 1e-3, 8 steps on one
    repeated batch of 8 x 512 tokens: the loss finite and falling by
    ``TRAIN_LOSS_DROP``, every query / key projection's gradient exactly
    zero under ``int`` with a finite non-zero global norm and non-zero
    under ``int_ste``; ms a step, tokens/s, the AdamW update alone, peak
    memory; (b) the smoke train step on the card against the CPU in f32
    (loss, every gradient and updated leaf within ``TRAIN_CARD_CPU_*``),
    microbatches=2 against 1 within ``TRAIN_MICRO_*`` and the compressed
    payload plus residual bitwise the gradients plus the old residual;
    (c) a checkpoint of full-width olmo-1b at 1 layer after 2 steps,
    restored bitwise (params, m, v, step) and the next step bitwise the
    live state's under ``torch.use_deterministic_algorithms``, bytes and
    seconds; (d) ``repro_torch.launch.serve`` in-process at full width
    with ``--warm-steps 8`` (trained against fp), then served paged with
    ``--kernel pallas``: K1 16 a prefill, K2 16 a decode step (the
    wrappers' count for steps run op by op, each captured graph's replays
    times its calls a replay in a device trace for the rest), no leaked
    blocks;
20. tensor-parallel serving (item 14) and qwen2.5-32b: (a) qwen2.5-32b at
    full width and depth (64 layers, 32.76 B parameters, 61.0 GiB of seeded
    bf16 weights drawn a layer at a time) served single-device on phase 6's
    trace cut to 8 requests with phase 6's options (no cost meter): K1 64 x 8, K2 64 x
    steps (the replays' kernels from the device trace), no leaked blocks,
    the pool's bytes ``pool_report``'s, graph == op by op on its first
    request, peak memory and ms a step; (b) the same weights at 8 layers
    (``TP_LAYERS``), the trace's first 4 requests (``TP_REQUESTS``), served
    single-device and over 2 and 4 shards on cuda:0
    (``make_serving_mesh(n, devices=[dev] * n)``) from the bf16 pool, and
    over 4 from the int8 pool: each sharded serve equal to the
    single-device serve of its pool bitwise (tokens and every step-aligned
    logit row; else tier (b): ``TP_ALIGNED_*``), K1 n x 8 x 4 and K2 n x
    8 x steps at the unsharded step's group, each shard's pool bytes
    ``pool_report``'s ``per_device_bytes``, one capture, graph == op by op
    on the first request, at most 20 aten ops a replayed step, ms a step
    at each n; (c) minicpm3-4b at 8 of its 62 layers, 4 requests, over 2
    shards through K4 on the gathered latent pool, (b)'s gates against its
    single-device serve;
21. the dry run against the card (item 15): ``launch/dryrun.py``'s cells
    of phases 4, 6, 19 and 20 on the meta device (on the host, seconds):
    (a) their argument bytes (parameters and cache, or the train state)
    equal what the phase allocated, exactly; (b) ``roofline.model_work``'s
    bound, each path's least time (a serve step's over the live keys of
    the step its graph replays), at most ``ROOFLINE_SHARE_LIMIT`` of the
    measured time (a replayed decode step's device span; the train step's
    wall), printed as the path's roofline share with the card's line;
    (c) the peak control: olmo-1b's decode step at batch 4 and 8 on the
    card, ``max_memory_allocated`` against the dry run's peak within
    ``PEAK_SLACK_BYTES``, the doubled batch moving both by the same
    amount. Every bound this script prints comes from
    ``repro_torch.launch.roofline`` (the card's rates by name, K1-K4's
    bounds, the weight-read, decode and 6 N T bounds);
22. a ``kernels`` JSON line per ported kernel (K2's int8 branch its own
    entry; ``launches_by_path`` with phase 20's paths), the card line, and
    the result line ``{"ok": true, "device": {...}}`` last.

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
blocks in reversed order, a chunk committing one position late), then
phase 14's checks (the rollback, the logit and token checks) on its first
8 requests served op by op through the gather path against two faults
of the verify step (``commit_staged`` leaving the last rejected position
uncleared, ``verify_mask`` letting query i see position i + 1), then
phase 16's (e) gates against two faults of the MoE shards (the experts'
outputs gathered in reverse shard order, the last shard's experts giving
zeros) and (g)'s a2a gates against each segment taking ``capacity()``'s
slots of the whole sequence, then phase 17's checks against four faults of the recurrent paths (the SSM
decode step without its D skip, which only ``REC_GEN_TOL`` can catch,
``commit_staged`` restoring the recurrent snapshot one step late,
``attn_decode_ring`` writing slot (pos + 1) % W, ``swap_write`` restoring
a stripe into another slot), then phase 18's checks against three faults
(M-RoPE's sections rotated on the card, each whisper slot decoding with its
neighbour's cross K/V, the M-RoPE serve step's positions outside its input
buffer), then phase 20's (b) gates against two faults of the sharded
forward (the heads gathered before ``wo`` in reverse shard order, every
shard's K2 giving zeros for its last kv-head), and prints which checks
catch each. Phases 13, 14 and 17's controls run at their cut depth.

    python3 probes/phase_seconds.py --root . --phases 16 16-faults

runs chosen phases (or their fault controls) alone, after the build, and
prints their seconds: a development run, with no kernels line and no
result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    from repro_torch.serving.graphs import capture

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with capture(g):
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


def profiled_events(run, pad):
    """The Kineto events (CPU and CUDA activity) of one torch.profiler
    session around ``run()``, with ``pad`` s of quiet time before and
    after it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        run()
        time.sleep(pad)
    return prof.profiler.kineto_results.events()


def traced_kernels(kind, calls, complete, pads=LAUNCH_CHECK_PADS):
    """Run each of ``calls`` (``(label, fn)``) once under one torch.profiler
    session, each inside ``record_function(label)``, and match the device
    trace's kernels to the runtime's launch calls (kernel and graph
    launches, host side) within each label's range by CUPTI's correlation
    id, not by time. A session for which ``complete(kernels)`` is false is
    run again with the next quiet time of ``pads``. Returns
    {label: launch call names}, {label: kernel events}, the launch calls
    outside every label, the kernels no label launched, and the pad."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    labels = [label for label, _ in calls]
    check(len(set(labels)) == len(labels), f"{kind}: traced labels repeat")

    def run():
        for label, fn in calls:
            with record_function(label):
                fn()
            torch.cuda.synchronize()

    for pad in pads:
        events = profiled_events(run, pad)
        ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU and e.name() in labels]
        check(len(ranges) == len(labels), f"{kind}: the profiler recorded "
              f"{len(ranges)} of {len(labels)} traced ranges")
        launches = {label: [] for label in labels}
        kernels = {label: [] for label in labels}
        caller, stray, orphans = {}, [], []
        for e in events:
            if e.device_type() == DeviceType.CPU and ("LaunchKernel" in e.name()
                                                      or "GraphLaunch" in e.name()):
                owner = [label for t0, t1, label in ranges if t0 <= e.start_ns() <= t1]
                if len(owner) != 1:
                    stray.append(e.name())
                    continue
                launches[owner[0]].append(e.name())
                caller[e.correlation_id()] = owner[0]
        for e in events:  # kernels (the labels' device-side ranges aside)
            if e.device_type() == DeviceType.CUDA and e.name() not in labels:
                if e.correlation_id() in caller:
                    kernels[caller[e.correlation_id()]].append(e)
                else:
                    orphans.append(e.name())
        if complete(kernels):
            break
    return launches, kernels, stray, orphans, pad


def launch_checks(kind, calls):
    """Run each of ``calls`` (``(label, fn, kernel, rec)``) once under one
    torch.profiler session (``traced_kernels``) and check that it made one
    CUDA kernel launch and that the device trace holds one kernel for it
    whose name contains ``kernel``. Writes the counts and names into
    ``rec``. A session that lost some label's kernel is run again with more
    quiet time; a kernel still missing after the last fails, as does any
    other count or name."""
    launches, kernels, stray, orphans, pad = traced_kernels(
        kind, [(label, fn) for label, fn, _, _ in calls],
        lambda kernels: all(kernels.values()))
    check(not stray, f"{kind}: launch calls outside the checked calls: {stray}")
    check(not orphans, f"{kind}: kernels no checked call launched: {orphans}")
    for label, _, kernel, rec in calls:
        names = [e.name() for e in kernels[label]]
        check(len(launches[label]) == 1,
              f"{kind} {label}: one call made the CUDA launches {launches[label]}")
        check(len(names) <= 1 and all(kernel in n for n in names),
              f"{kind} {label}: one call launched the kernels {names}, not one {kernel}")
        rec["cuda_launches_per_call"] = len(launches[label])
        rec["kernels_traced"] = names
    lost = [label for label, ks in kernels.items() if not ks]
    check(not lost, f"{kind}: the device trace lost the kernels of {lost} "
          f"with {LAUNCH_CHECK_PADS[-1]} s before and after the calls")
    print(f"{kind}: each of {len(calls)} calls made one CUDA launch, and the device "
          f"trace holds its kernel ({', '.join(sorted({k for _, _, k, _ in calls}))}; "
          f"torch.profiler, {pad} s before and after the calls)", flush=True)


def k1_case(label, x, mask, cfg, rate, launch_calls, reps=20):
    """Kernel vs plain version on one input, bitwise (and, for the split
    layout, the plain split version over the kernel's chunks); returns its
    record and adds its call to ``launch_calls`` (for ``launch_checks``)."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref, int_softmax_split_ref
    from repro_torch.launch import roofline as rl

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
    bound = rl.k1_bound(rows, cols, mask is not None, rate)
    kernel = lambda: ops.int_softmax_rows(x, cfg, mask)  # noqa: E731
    plain = lambda: int_softmax_ref(x, cfg, mask)  # noqa: E731
    rec = {"shape": label, "rows": rows, "cols": cols, "masked": mask is not None,
           "M": cfg.M, "max_abs_err": err, "layout": plan.layout,
           "per_thread": plan.per_thread, "rows_per_cta": plan.rows_per_cta,
           "cluster": plan.cluster, "chunk_cols": plan.chunk_cols,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, reps), "plain_call_ms": call_ms(plain, reps),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
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
    # the hymba-1.5b serve path (phase 17: 25 heads, 8 slots): a window
    # layer's ring decode, [8 x 25, 1024], masked by the ring's stored
    # positions (-1 where empty) as attn_decode_ring draws it: slots below
    # the window and wrapped ones
    w, rng = 1024, np.random.default_rng(2)
    qpos = torch.as_tensor(rng.integers(190, 2600, size=8), device=dev)
    i = torch.arange(w, device=dev)
    stored = qpos[:, None] - torch.remainder(qpos[:, None] - i[None, :], w)
    stored = torch.where(stored >= 0, stored, torch.full_like(stored, -1))
    ring = ((stored >= 0) & (stored <= qpos[:, None])
            & (stored > qpos[:, None] - w)).to(torch.uint8)
    recs.append(k1_case("hymba ring decode (8 x 25, 1024)", scores(200, w),
                        ring.repeat_interleave(25, dim=0), BEST, rate, calls))
    # the whisper-base serve path (phase 18: 8 heads, 1500 encoder frames,
    # 4 slots): the encoder's full attention at batch 1 (each admission)
    # and at batch 4, unmasked; a 32-token prompt's self-attention
    # (causal) and cross-attention (unmasked); a decode step's cross rows
    # (unmasked) and self rows over cache_len 96, each slot at its own
    # position
    enc = WHISPER_ENC_LEN
    recs.append(k1_case(f"whisper encoder (8 x {enc}), batch 1", scores(8 * enc, enc), None,
                        BEST, rate, calls))
    recs.append(k1_case(f"whisper encoder (4 x 8 x {enc}), batch 4", scores(32 * enc, enc),
                        None, BEST, rate, calls))
    recs.append(k1_case(f"whisper cross prefill (8 x 32, {enc})", scores(256, enc), None, BEST,
                        rate, calls))
    tril32 = torch.tril(torch.ones(32, 32, dtype=torch.uint8, device=dev))
    recs.append(k1_case("whisper self prefill (8 x 32, causal)", scores(256, 32),
                        tril32.repeat(8, 1), BEST, rate, calls))
    recs.append(k1_case(f"whisper cross decode (4 slots x 8, {enc})", scores(32, enc), None,
                        BEST, rate, calls))
    qpos = torch.as_tensor(np.random.default_rng(4).integers(4, 96, size=4), device=dev)
    m = (torch.arange(96, device=dev)[None, :] <= qpos[:, None]).to(torch.uint8)
    recs.append(k1_case("whisper self decode (4 slots x 8, 96)", scores(32, 96),
                        m.repeat_interleave(8, dim=0), BEST, rate, calls))
    # the qwen2-vl-7b generate path (phase 18: 28 heads, batch 4, prompt
    # 512): its prefill rows and its first decode step's (513 of 544 valid)
    recs.append(k1_case("qwen2-vl prefill (4 x 28 x 512)", scores(112 * 512, 512),
                        causal.repeat(112, 1), BEST, rate, calls))
    m = (torch.arange(544, device=dev) <= 512).expand(112, 544).to(torch.uint8).contiguous()
    recs.append(k1_case("qwen2-vl decode (4 x 28, 544)", scores(112, 544), m, BEST, rate,
                        calls))
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
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       pos.shape[1])
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
    from repro_torch.kernels.paged_attention.ref import k2_row_group, paged_attention_ref
    from repro_torch.launch import roofline as rl
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
    rg = k2_row_group(rows, cp, BS)
    # a verify block's rows against the decode step's: each entry t alone
    # (T 1 at its position) must give its rows bitwise (the split is the
    # decode step's, row groups change no bit)
    per_t = [torch.equal(ops.paged_attention_rows(
        q[:, :, t * group:(t + 1) * group].contiguous(), k, v, table,
        pos[:, t:t + 1].contiguous(), BEST, **kw), got[0][:, :, t * group:(t + 1) * group])
        for t in range(T)] if T > 1 else None
    if per_t is not None:
        check(all(per_t), f"K2 {label}: verify rows differ from the decode step's at "
              f"entries {[t for t, ok in enumerate(per_t) if not ok]}")
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
    bound = rl.k2_bound(q, k, v, table, pos, group=group, window=window,
                                quant=bool(quant), dtype=dtype, rate=rate)
    keys_read = bound["keys_read"]
    kernel = lambda: ops.paged_attention_rows(q, k, v, table, pos, BEST, **kw)  # noqa: E731
    plain = lambda: paged_attention_ref(q, k, v, table, pos, BEST, **kw)  # noqa: E731
    n_chunks = sum(len(c) for c in chunks)
    rec = {"shape": label, "S": S, "KV": KV, "rows": rows, "D": D, "BS": BS,
           "NLOG": NLOG, "window": window, "dtype": str(dtype).split(".")[-1],
           "pools": f"int8 ({quant})" if quant else str(dtype).split(".")[-1],
           "scores_dtype": str(scores_dtype).split(".")[-1],
           "keys_read": keys_read, "chunk_pages": cp, "row_group": rg,
           "live_ctas": n_chunks * KV * -(-rows // rg),
           "verify_rows_equal_decode": None if per_t is None else all(per_t),
           "max_abs_err": err, "max_err_over_rms": err / rms, "out_rms": rms,
           "scores_differing": res["scores_differing"],
           "outputs_differing": res["outputs_differing"], "repeat_bitwise": True,
           "score_bound_units": worst, "output_bound_units": out_units,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, 20), "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"]}
    print(f"K2 {label:<34} S={S} KV={KV} rows={rows} D={D} BS={BS} NLOG={NLOG} "
          f"w={window} {rec['dtype']}, pools {rec['pools']}, chunks of {cp} pages, rows in "
          f"groups of {rg} ({rec['live_ctas']} CTAs): Alg. 1 on own scores bitwise; repeat "
          f"bitwise; {'' if per_t is None else 'each entry of the block == T 1 at its position, bitwise; '}"
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
    # phase 14's verify round: K + 1 = 5 rows a slot at the serve shape
    recs.append(k2_case("T 5 (spec serve verify)", gen, rate, T=5,
                        qpos=np.minimum(qpos, 576 - 5), **main))
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
    # a verify block whose decode-step chunk (256 pages) holds a score tile
    # of 3 rows only: the 5 rows go in two groups under the same chunk
    recs.append(k2_case("T 5 in row groups, 32768 keys", gen, rate, S=8, KV=8, group=1,
                        T=5, NLOG=2048, qpos=np.arange(8) * 4000 + 3000))
    # phase 16's dbrx-132b serve: GQA 48/8 (group 6) at the serve's pool, its
    # decode step and its verify round
    dbrx = {**main, "KV": 8, "group": 6}
    recs.append(k2_case("dbrx-132b decode (GQA 48/8)", gen, rate, qpos=qpos, **dbrx))
    recs.append(k2_case("dbrx-132b verify T 5 (GQA 48/8)", gen, rate, T=5,
                        qpos=np.minimum(qpos, 576 - 5), **dbrx))
    # phase 16 (e)'s sharded dbrx-132b serve: each shard's K2 at its kv-heads
    # (8 / n), group 6, over its pool slice
    for n in MOE_TP_SHARDS["dbrx-132b"]:
        recs.append(k2_case(f"dbrx-132b shard decode, {n} shards (KV {8 // n}, group 6)", gen,
                            rate, qpos=qpos, **{**dbrx, "KV": 8 // n}))
    # phase 17's hymba-1.5b serve: its 3 global layers at GQA 25/5 (group
    # 5), D 64, over the serve's pool (cache_len 1024: the window) at its
    # decode step and its verify round
    hymba = dict(S=8, KV=5, group=5, D=64, BS=16, NLOG=64)
    hpos = np.random.default_rng(3).integers(192, 320, size=8)
    recs.append(k2_case("hymba-1.5b decode (GQA 25/5, D 64)", gen, rate, qpos=hpos, **hymba))
    recs.append(k2_case("hymba-1.5b verify T 5 (GQA 25/5, D 64)", gen, rate, T=5, qpos=hpos,
                        **hymba))
    # phase 18's qwen2-vl-7b serve: GQA 28/4 (group 7), D 128, over its
    # pool (8 slots x 34 pages of 16: cache_len 544, no prefix sharing)
    qwen = dict(S=8, KV=4, group=7, D=128, BS=16, NLOG=34, NB=272)
    recs.append(k2_case("qwen2-vl-7b decode (GQA 28/4)", gen, rate,
                        qpos=np.random.default_rng(5).integers(400, 544, size=8), **qwen))
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
        int_attention_ref, k3_plan, k3_smem_bytes, k3_tiles,
    )
    from repro_torch.launch import roofline as rl

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
    del got, want_sc, want_pr
    bound = rl.k3_bound(q, k, v, causal=causal, window=window, dtype=dtype,
                                rate=rate)
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
           "call_ms": call_ms(kernel, 10), "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"]}
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
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       pos.shape[1])
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
    from repro_torch.launch import roofline as rl

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
    # a verify block's rows against the decode step's, as in phase 5
    per_t = [torch.equal(ops.paged_attention_mla_rows(
        q_lat[:, t * H:(t + 1) * H].contiguous(), q_rope[:, t * H:(t + 1) * H].contiguous(),
        c, kr, table, pos[:, t:t + 1].contiguous(), BEST, scale=scale),
        got[0][:, t * H:(t + 1) * H]) for t in range(T)] if T > 1 else None
    if per_t is not None:
        check(all(per_t), f"K4 {label}: verify rows differ from the decode step's at "
              f"entries {[t for t, ok in enumerate(per_t) if not ok]}")
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
    bound = rl.k4_bound(q_lat, q_rope, c, kr, table, pos, heads=H, dtype=dtype,
                                rate=rate)
    keys_read = bound["keys_read"]
    kernel = lambda: ops.paged_attention_mla_rows(*args, scale=scale)  # noqa: E731
    plain = lambda: paged_attention_mla_ref(*args, scale=scale)  # noqa: E731
    tiles, groups = -(-rows // K4_TILE_ROWS), -(-R // 64)
    n_chunks = sum(len(ch) for ch in chunks)
    rec = {"shape": label, "S": S, "H": H, "T": T, "rows": rows, "R": R, "DR": DR,
           "BS": BS, "NLOG": NLOG, "dtype": str(dtype).split(".")[-1], "chunk_pages": cp,
           "verify_rows_equal_decode": None if per_t is None else all(per_t),
           "live_ctas": n_chunks * tiles, "pv_ctas": n_chunks * tiles * groups,
           "keys_read": keys_read,
           "max_abs_err": err, "max_err_over_rms": err / rms, "out_rms": rms,
           "scores_differing": res["scores_differing"],
           "outputs_differing": res["outputs_differing"], "repeat_bitwise": True,
           "score_share_differing": share,
           "score_bound_units": worst, "output_bound_units": out_units,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, 20), "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"]}
    print(f"K4 {label:<34} S={S} H={H} T={T} R={R} DR={DR} BS={BS} NLOG={NLOG} "
          f"{rec['dtype']}, chunks of {cp} pages ({rec['live_ctas']} CTAs, PV "
          f"{rec['pv_ctas']}): Alg. 1 on own scores bitwise; repeat bitwise; "
          f"{'' if per_t is None else 'each entry of the block == T 1 at its position, bitwise; '}scores "
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
    # phase 14's verify round: 5 x 40 = 200 rows a slot, four head tiles
    recs.append(k4_case("T 5 (spec serve verify, 200 rows)", gen, rate, T=5,
                        qpos=np.minimum(qpos, nlog * MLA_BS - 5), **main))
    recs.append(k4_case("deepseek-v2 width, 4096 keys", gen, rate, S=2, H=128, R=512,
                        DR=64, NLOG=256, qpos=np.array([4095, 3000]),
                        scale=(128 + 64) ** -0.5))
    # phase 16's deepseek-v2-236b serve: 8 slots over phase 6's pool (576
    # tokens a slot), its decode step and a verify round's 5 x 128 rows
    ds = dict(S=8, H=128, R=512, DR=64, BS=16, NLOG=36, NB=9 * 36, scale=(128 + 64) ** -0.5)
    dpos = np.random.default_rng(1).integers(400, 576, size=8)
    recs.append(k4_case("deepseek-v2-236b serve decode (H 128)", gen, rate, qpos=dpos, **ds))
    recs.append(k4_case("deepseek-v2-236b verify T 5 (640 rows)", gen, rate, T=5,
                        qpos=np.minimum(dpos, 576 - 5), **ds))
    # phase 16 (f)'s sharded deepseek-v2-236b serve: each shard's K4 at its
    # 64 heads over the latent pool gathered along the rank
    recs.append(k4_case("deepseek-v2-236b shard decode, 2 shards (H 64)", gen, rate, qpos=dpos,
                        **{**ds, "H": 64}))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
    return recs


# ---------------------------------------------- decode steps as CUDA graphs

# A replayed decode step asks the host for at most this many aten ops (the
# inputs copied in, the outputs read back) on a greedy path.
MAX_REPLAYED_STEP_OPS = 20


class StepOps:
    """While active, counts the aten ops the host dispatches inside the
    engine's decode-step method ``name`` (``"_serve_decode"``: one serve
    step, the host's lanes in to tokens on the host; ``"_fused_step"``: one
    fused generate step), over its first ``first_n`` calls (every call
    when None)."""

    def __init__(self, name, first_n=None):
        from repro_torch.serving.engine import Engine

        self.cls, self.name, self.first_n = Engine, name, first_n
        self.ops = self.steps = 0

    def __enter__(self):
        orig = self.orig = getattr(self.cls, self.name)

        def counted(eng, *args, **kw):
            if self.first_n is not None and self.steps >= self.first_n:
                return orig(eng, *args, **kw)
            counter = _OpCount()
            with counter:
                out = orig(eng, *args, **kw)
            self.ops += counter.n
            self.steps += 1
            return out

        setattr(self.cls, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)

    @property
    def per_step(self) -> float:
        return self.ops / max(self.steps, 1)


def graph_states(*engines):
    """The decode states of ``engines`` that hold a captured graph."""
    return [st for eng in engines for st in eng._decode_states.values()
            if st.graph is not None]


def op_by_op(eng):
    """``eng`` with its decode steps run op by op (no CUDA graph)."""
    eng._cuda_graphs = False
    return eng


def caches_equal(a, b) -> dict:
    """Leaf -> bitwise equal, over two decode states' caches (nested: the
    leaf's path)."""
    from repro_torch.launch import roofline as rl

    return {k: bool(torch.equal(x, y))
            for (k, x), (_, y) in zip(rl.named_leaves(a.cache), rl.named_leaves(b.cache))}


def cache_bytes(st) -> int:
    from repro_torch.launch import roofline as rl

    return rl.tree_bytes(st.cache)


def rows_equal(rows_a, rows_b) -> int:
    """How many requests' logit rows (recorder rows by seed) are bitwise
    equal, every row of each; -1 when the request sets differ."""
    if set(rows_a) != set(rows_b):
        return -1
    return sum(len(rows_a[s]) == len(rows_b[s]) and
               all(torch.equal(x, y) for x, y in zip(rows_a[s], rows_b[s]))
               for s in rows_a)


def replay_counts(eng) -> dict:
    """{step shape: graph replays so far} of ``eng``'s captured steps."""
    return {k: st.graph.replays for k, st in eng._decode_states.items()
            if st.graph is not None}


def replays_in(eng, before) -> dict:
    """{step shape: replays since ``before``} (a ``replay_counts``)."""
    now = replay_counts(eng)
    return {k: n - before.get(k, 0) for k, n in now.items() if n != before.get(k, 0)}


# Kernel calls in a device trace: K1 launches one kernel a call, K3 one, K2
# and K4 two or three (scores, sums for long rows, PV), so their PV launch
# counts the calls; K2's on int8 pools are its int8_t instances.
KERNEL_CALLS = {"K1": "k1_", "K2": "k2_pv", "K3": "k3_attention", "K4": "k4_pv"}


def kernel_calls(names) -> dict:
    """Calls of each kernel wrapper among the traced kernel ``names``,
    keyed as ``_kernel_counters`` plus "K2 on int8 pools"."""
    n = {k: sum(mark in name for name in names) for k, mark in KERNEL_CALLS.items()}
    n["K2 on int8 pools"] = sum("k2_pv" in name and "signed char" in name for name in names)
    return n


# Device time of one replayed step by kernel class: a kernel whose name
# holds a K prefix is that kernel's; cuBLAS / CUTLASS matrix products
# (cuBLAS 12.8+ names its own "nvjet_*") are GEMMs; everything else
# (elementwise, norms, rope, the quantizer, copies, gathers, argmax) is
# "rest".
STEP_TRACE_PADS = (1.0, 4.0, 16.0)


def _kernel_class(name: str) -> str:
    for k in ("k1_", "k2_", "k3_", "k4_"):
        if k in name:
            return k[:2].upper()
    low = name.lower()
    if any(t in low for t in ("nvjet", "gemm", "gemv", "cutlass", "xmma", "sm90_",
                              "cublas")):
        return "GEMM"
    return "rest"


def replay_trace(label, graphs, replays=3):
    """torch.profiler over ``replays`` replays of each of ``graphs``
    ({name: StepGraph}), each replay its own ``cudaGraphLaunch`` and its
    kernels matched to it (``traced_kernels``, padded sessions), a session
    kept when every replay of a graph shows the same kernel count. Per
    graph: the kernel calls of one replay (``kernel_calls``), and of its
    middle replay the device ms by class, the kernel count, the span from
    its first kernel's start to its last one's end, and the idle share of
    that span (no kernel running). Prints a line per graph; fails if a
    graph's replays launched no kernel or differ."""
    names = list(graphs)
    calls = [(f"{label}: graph {i} replay {r}", graphs[name])
             for i, name in enumerate(names) for r in range(replays)]

    def per_graph(kernels):
        return [[len(kernels[f"{label}: graph {i} replay {r}"]) for r in range(replays)]
                for i in range(len(names))]

    launches, kernels, _, _, pad = traced_kernels(
        label, calls, lambda ks: all(c[0] > 0 and len(set(c)) == 1 for c in per_graph(ks)),
        STEP_TRACE_PADS)
    counts = per_graph(kernels)
    check(all(c[0] > 0 and len(set(c)) == 1 for c in counts) and
          all(len(launches[lab]) == 1 for lab, _ in calls),
          f"{label}: kernels per replay {counts} over graph launches "
          f"{[len(launches[lab]) for lab, _ in calls]}")
    out = {}
    for i, name in enumerate(names):
        ks = sorted(kernels[f"{label}: graph {i} replay {replays // 2}"],
                    key=lambda e: e.start_ns())
        ms, rest = {}, {}
        for e in ks:
            c = _kernel_class(e.name())
            ms[c] = ms.get(c, 0.0) + e.duration_ns() / 1e6
            if c == "rest":
                key = e.name()[:60]
                n, t = rest.get(key, (0, 0.0))
                rest[key] = (n + 1, t + e.duration_ns() / 1e6)
        t0, t1 = ks[0].start_ns(), max(e.start_ns() + e.duration_ns() for e in ks)
        busy, end = 0, t0
        for e in ks:                 # union of the kernels' intervals
            a, b = max(e.start_ns(), end), e.start_ns() + e.duration_ns()
            if b > a:
                busy += b - a
            end = max(end, b)
        top = sorted(rest.items(), key=lambda kv: -kv[1][1])[:6]
        calls_per_replay = kernel_calls([e.name() for e in ks])
        rec = out[name] = {
            "path": label, "graph": str(name), "kernels": len(ks),
            "calls_per_replay": calls_per_replay, "span_ms": (t1 - t0) / 1e6,
            "device_ms": ms, "idle_share": 1 - busy / (t1 - t0),
            "rest_top": {k: {"kernels": n, "ms": t} for k, (n, t) in top}}
        print(f"  device trace of one replayed step, {label}, graph {i}: {len(ks)} kernels "
              f"over {rec['span_ms']:.4f} ms, kernel calls {calls_per_replay}, device ms "
              f"{ {k: round(v, 4) for k, v in sorted(ms.items())} }, idle share between "
              f"kernels {rec['idle_share']:.3f} (torch.profiler, {pad} s before and after); "
              f"the rest's largest: {[(k, n, round(t, 4)) for k, (n, t) in top]}", flush=True)
    return out


def replayed_graphs(eng, *replayed) -> dict:
    """{step shape: StepGraph} of ``eng`` for the shapes in ``replayed``."""
    return {k: eng._decode_states[k].graph for r in replayed for k in r}


def path_launches(label, counted, replayed, traces, want_per_replay):
    """The kernel launches of a run whose decode steps were graph replays:
    the wrappers' counts ``counted`` (launches outside the graphs: prefills,
    each graph's warm-up step) plus, for each graph, its replays in the run
    (``replayed``) times its kernel calls per replay in the device trace
    (``traces``, from ``replay_trace``). Gates each graph's calls per
    replay against ``want_per_replay``."""
    total = dict(counted)
    for k, n in replayed.items():
        per = traces[k]["calls_per_replay"]
        check(per == want_per_replay, f"{label}: kernel calls per replay {per}, expected "
              f"{want_per_replay}")
        for key in total:
            total[key] += n * per[key]
    print(f"  {label}: launches {total} = the wrappers' {counted} + "
          f"{ {str(k): n for k, n in replayed.items()} } replays x {want_per_replay} "
          f"traced per replay", flush=True)
    return total


# ----------------------------------------------------------------- phase 4


def graphed_generate(label, model, params, prompts, max_new, rounds, eager_mode=True,
                     extra=None):
    """``Engine.generate(mode="fused")`` of ``model`` at full width, its
    decode steps replayed as one CUDA graph (captured once), against the
    same steps op by op: K1 launches n_layers x max_new in both runs (the
    graphed run's replays counted from the device trace: ``path_launches``)
    and every other kernel none; tokens, last logits and the final cache
    bytes bitwise equal, and tokens
    and last logits equal to mode="eager"'s; finite logits, tokens in
    range. Then ``rounds`` rounds in turns of prefill
    alone, the graphed generate, the op-by-op one and (``eager_mode``)
    mode="eager" (host clock, synchronized), ms per decode step as
    (median generate - median prefill) / (max_new - 1) and the
    fused / eager decode ratio as ``benchmarks/decode_bench.py`` computes
    it; the aten ops the host dispatches per decode step in each mode; one
    replayed step's device trace. Gates: at most MAX_REPLAYED_STEP_OPS ops
    a replayed step, one capture, graph faster than op by op. ``extra``:
    the family's further prefill inputs (M-RoPE's positions) of every
    call."""
    from repro_torch.launch import roofline as rl
    from repro_torch.serving.engine import Engine

    extra = extra or {}

    cfg = model.cfg
    batch, prompt_len = prompts.shape
    print(f"{label}: {cfg.name} ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}), bf16 seeded weights, softmax "
          f"{cfg.softmax.kind}, batch {batch}, prompt {prompt_len}, max_new {max_new}, fused",
          flush=True)
    eng = Engine(model, params, max_new=max_new)
    eng_o = op_by_op(Engine(model, params, max_new=max_new))
    want = cfg.n_layers * max_new
    res, first_s, counted, replayed = {}, {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, e in (("graph", eng), ("op by op", eng_o)):
        zero_counters()
        before = replay_counts(e)
        t0 = time.perf_counter()
        res[name] = e.generate(prompts, report_cost=name == "graph", mode="fused",
                               extra_inputs=extra)
        torch.cuda.synchronize()
        first_s[name] = time.perf_counter() - t0
        counted[name], replayed[name] = read_counters(), replays_in(e, before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    g, o = res["graph"], res["op by op"]
    check(g.tokens.shape == (batch, prompt_len + max_new), "token shape")
    check(bool(((g.tokens >= 0) & (g.tokens < cfg.vocab)).all()), "token range")
    check(bool(torch.isfinite(g.logits).all()), "non-finite logits")
    (sg,), (so,) = eng._decode_states.values(), eng_o._decode_states.values()
    eq = caches_equal(sg, so)
    check(np.array_equal(g.tokens, o.tokens) and torch.equal(g.logits, o.logits)
          and all(eq.values()), f"{label}: graph and op by op differ (tokens "
          f"{np.array_equal(g.tokens, o.tokens)}, logits {torch.equal(g.logits, o.logits)}, "
          f"cache {eq})")
    captures = len(graph_states(eng))
    e = eng.generate(prompts, mode="eager", extra_inputs=extra)
    check(np.array_equal(e.tokens, g.tokens) and torch.equal(e.logits, g.logits),
          f"{label}: graph and mode='eager' differ")
    print(f"graph == op by op, bitwise: tokens, last logits and the final cache "
          f"({cache_bytes(sg)} B, leaves {sorted(eq)}); == mode='eager' in tokens and last "
          f"logits; graphs captured: {captures} "
          f"(one shape); first calls {first_s['graph'] * 1e3:.1f} / "
          f"{first_s['op by op'] * 1e3:.1f} ms (graph, capture included / op by op); "
          f"peak device memory {peak:.2f} GiB", flush=True)
    check(captures == 1, f"{label}: {captures} graphs captured, expected 1")
    # K1 launches: op by op, the wrappers' count; graphed, the prefill's and
    # the warm-up step's plus the replays times the kernels one replay
    # launched in the device trace
    per_replay = {k: 0 for k in counted["graph"]}
    per_replay["K1"] = cfg.n_layers
    traces = replay_trace(label, replayed_graphs(eng, replayed["graph"]))
    n = path_launches(label, counted["graph"], replayed["graph"], traces, per_replay)
    for name, got in (("graph", n), ("op by op", counted["op by op"])):
        print(f"K1 launches in one generate, {name}: {got['K1']} (expected {cfg.n_layers} "
              f"layers x {max_new} steps = {want}), all {got}", flush=True)
        check(got["K1"] == want and got == dict(counted["op by op"]),
              f"{label}, {name}: launches {got}, expected K1 {want} and the op-by-op "
              f"{counted['op by op']}")
    if g.cost is not None:
        print(f"batch softmax AP cost: {g.cost.describe()}", flush=True)

    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    runs = [("graph", lambda: eng.generate(prompts, mode="fused", extra_inputs=extra)),
            ("op by op", lambda: eng_o.generate(prompts, mode="fused", extra_inputs=extra))]
    if eager_mode:
        runs.append(("eager", lambda: eng.generate(prompts, mode="eager",
                                                   extra_inputs=extra)))
    extra_dev = {k: torch.as_tensor(np.array(v), device="cuda") for k, v in extra.items()}
    walls = {name: [] for name in ["prefill"] + [n for n, _ in runs]}
    for _ in range(rounds):
        walls["prefill"].append(wall(lambda: model.prefill(
            params, {"tokens": tokens, **extra_dev}, cache_len=prompt_len + max_new))[0])
        for name, fn in runs:
            dt, r = wall(fn)
            check(np.array_equal(r.tokens, g.tokens), f"{label}: repeat {name} differs")
            walls[name].append(dt)
    med = {k: statistics.median(v) for k, v in walls.items()}
    step_ms = {n: (med[n] - med["prefill"]) / (max_new - 1) * 1e3 for n, _ in runs}
    with StepOps("_fused_step") as og:
        eng.generate(prompts, mode="fused", extra_inputs=extra)
    with StepOps("_fused_step", first_n=2) as oo:
        eng_o.generate(prompts, mode="fused", extra_inputs=extra)
    rec = {"path": label, "arch": cfg.name, "batch": batch, "prompt": prompt_len,
           "max_new": max_new, "launches_K1": n["K1"], "launches": n,
           "replays": sum(replayed["graph"].values()), "captures": captures,
           "peak_gib": peak, "walls_s": walls, "ms_per_step": step_ms,
           "tok_s": {n: batch * max_new / med[n] for n, _ in runs},
           "prefill_ms": med["prefill"] * 1e3,
           "aten_ops_per_step": {"graph": og.per_step, "op by op": oo.per_step}}
    line = (f"generate ({rounds} rounds in turns, medians): prefill "
            f"{med['prefill'] * 1e3:.2f} ms; " + "; ".join(
                f"{n} {med[n] * 1e3:.1f} ms = {rec['tok_s'][n]:.1f} tok/s, "
                f"{step_ms[n]:.3f} ms per decode step" for n, _ in runs))
    if eager_mode:
        rec["fused_over_eager"] = ((med["eager"] - med["prefill"])
                                   / (med["graph"] - med["prefill"]))
        line += (f"; fused / eager decode {rec['fused_over_eager']:.2f}x (the reference's "
                 "CI contract: >= 3x, benchmarks/decode_bench.py --min-speedup 3; not "
                 "gated here)")
    print(line + f" ({card_line()})", flush=True)
    print(f"host work per decode step: {og.per_step:.1f} aten ops replayed (limit "
          f"{MAX_REPLAYED_STEP_OPS}; {og.steps} steps) against {oo.per_step:.0f} op by op "
          f"(+{cfg.n_layers} K1 launches through ctypes)", flush=True)
    check(og.per_step <= MAX_REPLAYED_STEP_OPS,
          f"{label}: {og.per_step} aten ops per replayed step")
    check(step_ms["graph"] < step_ms["op by op"],
          f"{label}: graph {step_ms['graph']} ms per step not below op by op "
          f"{step_ms['op by op']}")
    (rec["trace"],) = traces.values()
    rec["param_bytes"] = rl.tree_bytes(params)
    rec["cache_bytes"] = cache_bytes(sg)
    rec["cache_len"] = prompt_len + max_new
    return rec, g


# The smoke config on the card against the CPU (f32, the same weights): a
# score within an ulp of a rounding boundary of the M-bit grid may take
# the neighbouring Alg.-1 code on one side only.
SMOKE_CARD_CPU_TOL = 1e-2


def smoke_card_vs_cpu(arch, make_batch):
    """The smoke config of ``arch`` in f32 on the card (K1) against the same
    weights on the CPU (K1's plain version): a prefill of
    ``make_batch(cfg)`` (tokens and the family's inputs, numpy) and 7
    decode steps. Returns (the last logits' max |diff|, greedy tokens
    equal); the callers hold them to SMOKE_CARD_CPU_TOL."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    scfg = smoke_config(arch, softmax=SoftmaxSpec("int_pallas"))
    cpu_model = Model(scfg, dtype=torch.float32, device="cpu")
    cpu_params = cpu_model.init(torch.Generator("cpu").manual_seed(0))
    batch = make_batch(scfg)
    tokens, extra = batch.pop("tokens"), batch
    on_cpu = Engine(cpu_model, cpu_params, max_new=8).generate(tokens, extra_inputs=extra)
    on_gpu = Engine(Model(scfg, dtype=torch.float32), _tree_to(cpu_params, "cuda"),
                    max_new=8).generate(tokens, extra_inputs=extra)
    err = float((on_gpu.logits.cpu() - on_cpu.logits).abs().max())
    return err, bool(np.array_equal(on_gpu.tokens, on_cpu.tokens))


# llama2-7b's depth in phase 4, and qwen2-vl-7b's in phase 18: half of
# each model's (32, 28), at full width, to keep the whole run inside its
# time on slower hosts once phase 19 was added (PERF.md §6, training and
# checkpoints: the run took 1147 s on one host with both at full depth;
# each phase's seconds before and after in one call). Every launch count
# and check follows the config.
LLAMA_LAYERS, QWEN_LAYERS = 16, 14


def phase4_main_path():
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    batch, prompt_len, max_new = 4, 512, 32
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)                       # bf16 on the card
    params = model.init(torch.Generator("cuda").manual_seed(0))
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)
    prompts = corpus.sample(batch, prompt_len, seed=777)[:, :prompt_len]
    rec, res = graphed_generate("main path", model, params, prompts, max_new, rounds=3)

    # the same weights with the plain torch Alg. 1 on the card
    plain = Engine(Model(cfg.with_softmax(SoftmaxSpec("int"))), params, max_new=max_new)
    res_int = plain.generate(prompts, mode="fused")
    check(np.array_equal(res_int.tokens, res.tokens), "int vs int_pallas tokens differ")
    check(torch.equal(res_int.logits, res.logits), "int vs int_pallas last logits differ")
    print("int_pallas vs int (plain Alg. 1) on the card: tokens and last logits "
          "bitwise equal", flush=True)
    del plain, params, res, res_int
    torch.cuda.empty_cache()

    # small input: the card against the CPU, same f32 weights
    err, same = smoke_card_vs_cpu("olmo-1b", lambda scfg: {
        "tokens": SyntheticCorpus(scfg.vocab, seed=1234).sample(2, 8, seed=5)[:, :8]})
    check(same, "smoke: card vs CPU tokens differ")
    check(err <= SMOKE_CARD_CPU_TOL, f"smoke: card vs CPU logits differ by {err}")
    print(f"smoke olmo-1b f32, card (K1) vs CPU (plain): greedy tokens equal, last "
          f"logits max abs diff {err:.3e} (bound {SMOKE_CARD_CPU_TOL}: a score on a rounding "
          f"boundary may quantize differently)", flush=True)

    # llama2-7b, the paper's own model, at full width through the same path
    lcfg = get_config("llama2-7b", softmax=SoftmaxSpec("int_pallas"), n_layers=LLAMA_LAYERS)
    lmodel = Model(lcfg)
    lparams = lmodel.init(torch.Generator("cuda").manual_seed(0))
    lprompts = SyntheticCorpus(lcfg.vocab, seed=1234).sample(batch, prompt_len,
                                                               seed=777)[:, :prompt_len]
    lrec, _ = graphed_generate("llama2-7b generate", lmodel, lparams, lprompts, max_new,
                               rounds=2, eager_mode=False)
    del lmodel, lparams
    torch.cuda.empty_cache()
    rec["llama2-7b"] = lrec
    return rec


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

# Phases 13 and 14 serve olmo-1b at OLMO_CUT_LAYERS of its 16 layers, at
# full width (the run's budget: ROADMAP.md, "The card budget"), and hold it
# to phase 6's rules at 1.3 times the largest reading of every sound run at
# that depth on the H100 (PERF.md §6): teacher-forced max 0.07812 and
# RMS 0.01261 (phase 13's and 14's int8 serves; bf16 0.07031 / 0.01229, the
# fault controls' clean runs 0.07031 / 0.01229 and 0.06641 / 0.01204). Step
# by step every sound run read 0 against its plain serve (chunked, swapped
# and speculative serves equal it bitwise), so those limits are 0. The
# faults of --fault-control read 0.7578-1.373 (RMS 0.05772-0.103), or are
# caught by the rollback and the swap round trip alone, as at full depth.
OLMO_CUT_LAYERS = 8
CUT_LOGIT_TOL, CUT_LOGIT_RMS_TOL = 1.3 * 0.07812, 1.3 * 0.01261
CUT_ALIGNED_TOL, CUT_ALIGNED_RMS_TOL = 0.0, 0.0

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


def text_inputs(model, seq) -> dict:
    """A text-only sequence's further inputs beside its tokens ``seq`` [B,
    S]: an M-RoPE model's three position streams all on the token axis (as
    its serve's prefills put them), else none."""
    if model.cfg.rope_type != "mrope":
        return {}
    b, s = seq.shape
    return {"positions": torch.arange(s, dtype=torch.int32, device=seq.device).expand(3, b, s)}


def full_logits(model, params, seq, extra=None):
    """Logits at every position of ``seq`` [1, S] from one causal pass
    (``extra``: the encoder-decoder's frames; an M-RoPE model's text-only
    streams are added):
    ``Model.train_logits``, or for an int8 KV cache the prefill's layer loop
    (each layer attends the fake-quantized K/V it caches, as serving does)
    with the head over every position. An SSM or hybrid model's sequence
    longer than a chunk is zero-padded on the right to the SSD chunk grid
    (``ssm.ssd_chunked``'s rule) and the logits sliced back: the model is
    causal, so the tokens after a position change none of its logits."""
    cfg, s = model.cfg, seq.shape[1]
    if cfg.family in ("ssm", "hybrid") and s > cfg.ssm_chunk and s % cfg.ssm_chunk:
        seq = F.pad(seq, (0, cfg.ssm_chunk - s % cfg.ssm_chunk))
        return full_logits(model, params, seq)[:, :s]
    if not model.cfg.kv_quant:
        batch = {"tokens": seq, **text_inputs(model, seq), **(extra or {})}
        return model.train_logits(params, batch)[0]
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
    teacher-forced pass is ``full_logits`` of ``model``, with the
    request's encoder frames where it carries them."""
    first = decode = sq = 0.0
    n = 0
    for r, toks in zip(reqs, tokens):
        got = rows[r.seed]
        check(len(got) == r.max_new, f"{label}, request {r.rid}: {len(got)} sampled rows")
        seq = torch.as_tensor(np.asarray(toks[:-1])[None], dtype=torch.long,
                              device="cuda")
        extra = ({"frames": torch.as_tensor(r.frames[None], device="cuda")}
                 if r.frames is not None else None)
        ref = full_logits(model, params, seq, extra)[0, r.prompt_len - 1:]
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
          f"(limits {tol:.4g}, RMS {rms_tol:.4g})", flush=True)
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


def _near_tie_bound(top: float) -> float:
    """NEAR_TIE_ULPS bf16 ulps of a logit ``top``."""
    return NEAR_TIE_ULPS * 2.0 ** (float(np.floor(np.log2(abs(top)))) - 7)


def _margin(model, params, tokens):
    """Top logit and top-2 margin of the next-token logits after ``tokens``,
    by a teacher-forced prefill of the reference's own tokens; for an MoE
    model also the router's closest call at the last token over the MoE
    layers: the smallest margin between its k-th and (k+1)-th router
    logits in units of its near-tie bound (``_near_tie_bound`` of the k-th
    logit; below 1: a routing near tie), else None."""
    batch = {"tokens": torch.as_tensor(np.asarray(tokens)[None], dtype=torch.long,
                                       device="cuda")}
    batch.update(text_inputs(model, batch["tokens"]))
    router = []
    if model.cfg.family == "moe":
        from repro_torch.models import moe
        from repro_torch.models.layers import dense_apply

        route = moe._route

        def traced(p, x, cfg, ctx):
            logits = dense_apply(p["router"], x, ctx).float()[0, -1]
            top = torch.sort(logits, descending=True).values
            kth, nxt = float(top[cfg.moe_top_k - 1]), float(top[cfg.moe_top_k])
            router.append((kth - nxt) / _near_tie_bound(kth))
            return route(p, x, cfg, ctx)

        moe._route = traced
    try:
        if model.cfg.family in ("ssm", "hybrid"):
            # a prompt off the SSD chunk grid: the causal forward pads it
            logits = full_logits(model, params, batch["tokens"])
        else:
            logits, _ = model.prefill(params, batch, cache_len=len(tokens))
    finally:
        if model.cfg.family == "moe":
            moe._route = route
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0]), float(top[0] - top[1]), (min(router) if router else None)


def first_divergence(label, got, want, prompt_len, model, params):
    """None for equal token rows; else the first divergent step with the
    reference's top logit and top-2 margin there, and whether that margin
    is a near tie (below NEAR_TIE_ULPS bf16 ulps of the top logit). For an
    MoE model a routing near tie at that token counts too: a router whose
    k-th and (k+1)-th logits lie that close in some MoE layer picks either
    expert under the rounding a near-tie token sees, and the expert it picks
    moves that token's FFN output, and so its logits, by O(1)."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if diff.size == 0:
        return None
    k = int(diff[0])
    check(k >= prompt_len, f"{label}: prompt differs")
    top, margin, router = _margin(model, params, want[:k])
    bound = _near_tie_bound(top)
    out = {"run": label, "step": k - prompt_len, "margin": margin, "top": top,
           "near_tie_bound": bound, "near_tie": margin < bound}
    if router is not None:
        out.update(router_margin_in_bounds=router, logit_near_tie=out["near_tie"],
                   near_tie=out["near_tie"] or router < 1)
    if not out["near_tie"] or router is not None:
        print(f"  divergence, {label}: step {out['step']}, top-2 logit margin {margin:.4g} "
              f"(near-tie bound {bound:.4g})"
              + ("" if router is None else f", closest routing call {router:.4g} near-tie "
                 f"bounds") + f"; near tie: {out['near_tie']}", flush=True)
    return out


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


def serve_graph_vs_op(label, reqs, graphed, op, gate=True):
    """A serve with its decode steps as CUDA-graph replays against the same
    serve op by op (each ``(report, recorder rows, engine)``): tokens,
    every logit row and the final pool bytes bitwise equal, and the same
    schedule. Prints one line; returns the record (the caller compares the
    launches once the graphs' replays are traced: ``path_launches``).
    ``gate`` False: the caller reads the record instead of failing here."""
    (rep_g, rows_g, eng_g), (rep_o, rows_o, eng_o) = graphed, op
    keys = [k for k in eng_o._decode_states if k in eng_g._decode_states]
    eq = {k: caches_equal(eng_g._decode_states[k], eng_o._decode_states[k]) for k in keys}
    out = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                         for a, b in zip(rep_g.results, rep_o.results)),
           "logit_rows": rows_equal(rows_g, rows_o) == len(reqs),
           "pool_bytes": bool(keys) and all(all(e.values()) for e in eq.values()),
           "schedule": all(getattr(rep_g, f) == getattr(rep_o, f) for f in (
               "steps", "preemptions", "resumes", "max_prefill_per_step",
               "prefill_tokens", "shared_prefill_tokens", "leaked_blocks"))}
    nbytes = sum(cache_bytes(eng_g._decode_states[k]) for k in keys)
    print(f"  graph == op by op, {label}: {out} ({sum(len(v) for v in rows_g.values())} "
          f"logit rows, {nbytes} pool bytes, {rep_g.steps} steps)", flush=True)
    check(not gate or all(out.values()),
          f"{label}: the graphed serve differs from op by op: {out}")
    return out


def same_launches(label, record, graphed, op):
    """The graphed serve's launches (``path_launches``) equal op by op's."""
    record["launches"] = graphed == op
    check(graphed == op, f"{label}: graphed launches {graphed} != op by op {op}")


def serve_timing(label, reqs, plan, graph="graph", op="op by op"):
    """Warm serves on the host clock, in the order of ``plan`` ((name,
    engine, options) triples). Per name: ms per step of each run (wall /
    steps, prefills included) and at the median wall, generated tok/s, the
    most prompt tokens prefilled in a step, and the time between tokens over
    every emission of its runs (and over the requests never preempted).
    The aten ops the host dispatches per decode step: over every step of
    the last ``graph`` run, and the first two steps of the first ``op`` run
    (the costly one: one of it between two graphed runs). Every run of one
    name gives the tokens of its first, and ``graph`` and ``op`` give the
    same tokens. Gates: at most MAX_REPLAYED_STEP_OPS ops a replayed greedy
    step; ``graph`` faster than ``op`` per step."""
    import dataclasses

    gen_tokens = sum(r.max_new for r in reqs)
    runs, counted = {}, {}
    last_graph = max(i for i, (m, _, _) in enumerate(plan) if m == graph)
    first_op = min(i for i, (m, _, _) in enumerate(plan) if m == op)
    for i, (name, eng, opts) in enumerate(plan):
        ctx = (StepOps("_serve_decode") if i == last_graph else
               StepOps("_serve_decode", first_n=2) if i == first_op else
               contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            rep = eng.serve(reqs, dataclasses.replace(opts, report_cost=False))
        torch.cuda.synchronize()
        runs.setdefault(name, []).append((time.perf_counter() - t0, rep))
        if i in (last_graph, first_op):
            counted[name] = ctx.per_step
    card = card_line()
    out = {}
    for name, rs in runs.items():
        first = rs[0][1]
        for _, r in rs[1:]:
            check(all(np.array_equal(a.tokens, b.tokens)
                      for a, b in zip(first.results, r.results)),
                  f"{label}, {name}: repeat serve differs")
        med = statistics.median(w for w, _ in rs)
        t = out[name] = {"walls_ms": [w * 1e3 for w, _ in rs], "steps": first.steps,
                         "ms_per_step_runs": [w * 1e3 / r.steps for w, r in rs],
                         "ms_per_step": med * 1e3 / first.steps,
                         "tok_s": gen_tokens / med, "aten_ops_per_step": counted.get(name),
                         "max_prompt_tokens_per_step": first.max_prefill_per_step}
        results = [r for _, rep in rs for r in rep.results]
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
        gap = ("" if t["preempted_longest_gap_ms"] is None else
               f"; a preempted request's longest gap {t['preempted_longest_gap_ms']:.2f} ms")
        print(f"  {label}, {name} ({len(rs)} warm run(s) in the order "
              f"{[m for m, _, _ in plan]}): walls {[round(x, 1) for x in t['walls_ms']]} ms, "
              f"{t['ms_per_step']:.3f} ms per step (median wall / {t['steps']} steps, "
              f"prefills included; runs {[round(x, 3) for x in t['ms_per_step_runs']]}), "
              f"{t['tok_s']:.1f} generated tok/s, max prompt tokens in a step "
              f"{t['max_prompt_tokens_per_step']}, time between tokens p50 "
              f"{t['tbt_p50_ms']:.2f} / p99 {t['tbt_p99_ms']:.2f} / max {t['tbt_max_ms']:.2f} "
              f"ms, never preempted p50 {t['tbt_never_preempted_p50_ms']:.2f} / p99 "
              f"{t['tbt_never_preempted_p99_ms']:.2f} / max "
              f"{t['tbt_never_preempted_max_ms']:.2f} ms{gap} ({card})", flush=True)
    g, o = runs[graph][0][1], runs[op][0][1]
    check(all(np.array_equal(a.tokens, b.tokens) for a, b in zip(g.results, o.results)),
          f"{label}: graphed and op-by-op greedy tokens differ")
    print(f"  {label}, host work per decode step: {counted[graph]:.1f} aten ops replayed "
          f"(limit {MAX_REPLAYED_STEP_OPS}) against {counted[op]:.0f} op by op", flush=True)
    check(counted[graph] <= MAX_REPLAYED_STEP_OPS,
          f"{label}: {counted[graph]} aten ops per replayed step")
    check(out[graph]["ms_per_step"] < out[op]["ms_per_step"],
          f"{label}: graph {out[graph]['ms_per_step']} ms per step not below op by op "
          f"{out[op]['ms_per_step']}")
    return out


def step_launches(cfg, name, kv_quant=False) -> dict:
    """The kernels one serve decode step of ``cfg`` launches: the fused paged
    decode ``name`` ("K2" / "K4") on every paged layer (and K2's int8
    branch on each with ``kv_quant``); a hybrid model's window layers
    decode from their rings through K1 and only its global layers page."""
    if cfg.family == "hybrid":
        from repro_torch.models.kv_cache import hybrid_segments

        n_win = sum(hybrid_segments(cfg))
        return {name: cfg.n_layers - n_win, "K1": n_win}
    per = {name: cfg.n_layers}
    if kv_quant:
        per["K2 on int8 pools"] = cfg.n_layers
    return per


def serve_launches(cfg, name, kv_quant, counted, prefills, steps) -> dict:
    """Every counter of ``counted`` at 0 but K1 n_layers x ``prefills`` and
    ``step_launches`` x ``steps``."""
    want = {k: 0 for k in counted}
    want["K1"] = cfg.n_layers * prefills
    for k, v in step_launches(cfg, name, kv_quant).items():
        want[k] = want.get(k, 0) + v * steps
    return want


def serve_phase(arch, reqs, opts, *, fused, eager_n, logit_tol, logit_rms_tol,
                aligned_tol, aligned_rms_tol, max_new, kv_quant=False, model=None,
                params=None, control=False):
    """Full-width ``arch`` served through Engine.serve with the paged pool,
    prefix sharing and ``kernel="pallas"``: the fused paged decode
    ``fused`` (the ``ops`` function whose counter it bumps) launches as
    ``step_launches`` x steps, every call at (T 1, its query rows), K1
    n_layers x requests (the prefills and tail prefills), no other paged
    decode kernel at all; with ``prefix_share`` a prefix is shared (never
    for the recurrent families, whose state summarises the whole prefix),
    without it none is. Greedy tokens
    equal ``kernel="jnp"`` and per-request eager (the first ``eager_n``
    requests) but at near ties; every served logit within ``logit_tol``
    (RMS ``logit_rms_tol``) of a teacher-forced forward of the served
    tokens, and the pallas and jnp serves' logits within ``aligned_tol``
    (RMS ``aligned_rms_tol``) of each other step by step. The decode steps
    are CUDA-graph replays (their kernels counted from the device trace:
    ``path_launches``, which also gives one replayed step's device time);
    the checked serve equals the same serve op by op bitwise (tokens, logit
    rows, pool bytes, the op-by-op launches as its steps imply) on the first
    SERVE_OP_SUBSET requests, each engine captures once per step shape,
    and the greedy serve is timed graphed and op by op in turns
    (``serve_timing``). ``kv_quant``: the int8 KV pool (absmax); K2 must then
    launch on int8 pools every time, and the teacher-forced pass quantizes
    as the prefill does. ``model`` / ``params``: the model to serve (else
    ``arch`` at full size, seeded). ``control``: a serve with ``fused``
    leaving out each sequence's first page must fail the teacher-forced
    limits."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    if model is None:
        cfg = dataclasses.replace(get_config(arch, softmax=SoftmaxSpec("int_pallas")),
                                  kv_quant=kv_quant)
        model = Model(cfg)
        params = model.init(torch.Generator("cuda").manual_seed(0))
    cfg = model.cfg
    eng = Engine(model, params, max_new=max_new)
    gen_tokens = sum(r.max_new for r in reqs)
    counters = _kernel_counters()
    name = next(k for k, f in counters.items() if f is fused)
    rows_per_call = cfg.n_heads if name == "K4" else cfg.n_heads // cfg.n_kv_heads
    shares = opts.prefix_share and cfg.family not in ("ssm", "hybrid")
    print(f"serve path: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers), bf16 seeded weights, softmax int_pallas; {len(reqs)} "
          f"requests (prompts {min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, max_new {min(r.max_new for r in reqs)}-"
          f"{max(r.max_new for r in reqs)}, {gen_tokens} tokens), slots {opts.slots}, paged "
          f"bs {opts.block_size}, {'prefix_share' if opts.prefix_share else 'no prefix_share'}, "
          f"kernel pallas ({name}), KV pool "
          f"{'int8 (absmax)' if kv_quant else 'bf16'}", flush=True)

    # the checked runs sample through a recorder (greedy, per slot) that
    # keeps every logits row; the timed runs below use ``eng``
    rec = _LogitRecorder()
    eng_r = Engine(model, params, max_new=max_new, sampler=rec)
    torch.cuda.reset_peak_memory_stats()
    with KernelWidths() as widths:
        rep, counted, rows_pallas, first_s, replayed = counted_serve(eng_r, reqs, opts, rec)
    # what the checked serve allocated: its parameters and its step's pool;
    # the live keys of each slot in the step its graph replays (the last)
    st = [s for k, s in eng_r._decode_states.items()
          if k[:2] == ("serve", "pallas") and k[4] == rep.cache_len][-1]
    alloc = {"param_bytes": rl.tree_bytes(params), "pool_bytes": cache_bytes(st),
             "cache_len": rep.cache_len, "num_blocks": eng_r._last_alloc.num_blocks,
             "slots": opts.slots, "block_size": opts.block_size,
             "step_keys": rl.live_keys(st.cache, st.buffers[0][1])}
    del st
    PLAIN_SERVES[arch, kv_quant] = {"rep": rep, "rows": rows_pallas}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec.rows = {}
    check(len(rep.results) == len(reqs), "not every request completed")
    for r, res in zip(reqs, rep.results):
        check(res.rid == r.rid and res.tokens.shape == (r.prompt_len + r.max_new,),
              f"request {r.rid}: token shape")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              f"request {r.rid}: token range")
    check((rep.shared_prefill_tokens > 0) == shares,
          f"{rep.shared_prefill_tokens} prefix tokens shared (a {cfg.family} model shares "
          f"{'some' if shares else 'none'})")
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
    # graph == op by op on the first SERVE_OP_SUBSET requests, each served
    # graphed and op by op by a fresh engine; the op-by-op serve's launches
    # (all counted by the wrappers) as its steps imply
    sub = reqs[:SERVE_OP_SUBSET]
    runs = []
    for graphed in (True, False):
        r2 = _LogitRecorder()
        e2 = Engine(model, params, max_new=max_new, sampler=r2)
        if not graphed:
            op_by_op(e2)
        rep2, n2, rows2, _, _ = counted_serve(e2, sub, opts, r2)
        runs.append(((rep2, rows2, e2), n2))
    graph_vs_op = serve_graph_vs_op(f"{cfg.name} serve, first {len(sub)} requests", sub,
                                    runs[0][0], runs[1][0])
    (rep_o, _, _), n_o = runs[1]
    del runs
    same_launches(f"{cfg.name} serve, first {len(sub)} requests op by op", graph_vs_op,
                  serve_launches(cfg, name, kv_quant, n_o, len(sub), rep_o.steps), n_o)
    per_replay = serve_launches(cfg, name, kv_quant, counted, 0, 1)
    traces = replay_trace(f"{cfg.name} serve", replayed_graphs(eng_r, replayed))
    n = path_launches(f"{cfg.name} serve", counted, replayed, traces, per_replay)
    want = serve_launches(cfg, name, kv_quant, n, len(reqs), rep.steps)
    w = widths.widths(name)
    print(f"launches in one serve: {n} (expected {want}: {step_launches(cfg, name, kv_quant)} "
          f"a step x {rep.steps} steps, K1 {cfg.n_layers} x {len(reqs)} prefills); {name} "
          f"calls at (T, rows) {w} (expected [(1, {rows_per_call})]); first serve "
          f"{first_s * 1e3:.1f} ms, peak device memory {peak:.2f} GiB", flush=True)
    check(n == want, f"kernel launches {n} != {want}")
    check(w == [(1, rows_per_call)], f"{cfg.name} serve: {name} ran at (T, rows) {w}")

    ties = []
    rep_j = eng_r.serve(reqs, dataclasses.replace(opts, kernel="jnp", report_cost=False))
    rows_jnp, rec.rows = rec.rows, {}
    for a, b in zip(rep.results, rep_j.results):
        compare_tokens(f"pallas vs jnp, request {a.rid}", a.tokens, b.tokens,
                       a.prompt_len, model, params, ties)
    eager = []
    for r, res in list(zip(reqs, rep.results))[:eager_n]:
        extra = text_inputs(model, torch.as_tensor(r.prompt[None], device="cuda"))
        ref = eng_r.generate(r.prompt[None],
                             generator=torch.Generator("cuda").manual_seed(r.seed),
                             mode="eager", max_new=r.max_new, cache_len=rep.cache_len,
                             extra_inputs=extra)
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

    def beyond(c):
        return [k for k, v in (
            ("logit_max", max(c["first_step_max"], c["decode_max"]) > logit_tol),
            ("logit_rms", c["rms"] > logit_rms_tol)) if v]

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
        check(not beyond(c), f"{c['run']}: served logits differ from the teacher-forced "
              f"prefill's beyond the limits: {c}")
    to_bf16 = None
    if kv_quant:        # information only: what the int8 pool costs in logits
        to_bf16 = teacher_forced("int8 serve kernel=pallas vs the bf16 model (information)",
                                 Model(dataclasses.replace(cfg, kv_quant=False)), params,
                                 reqs, [res.tokens for res in rep.results], rows_pallas,
                                 float("inf"), float("inf"))
    ctrl = None
    if control:
        # the same serve, graphed by a fresh engine (its step graph captured
        # with the fault), the fused kernel leaving out the first page of
        # every sequence's keys; the teacher-forced limits must fail it
        from repro_torch.kernels.paged_attention import ops as paged_ops

        attr, at = MOE_CONTROL[name]
        sound = getattr(paged_ops, attr)
        setattr(paged_ops, attr, _first_page_left_out(sound, at))
        rec.rows = {}
        try:
            rep_c = Engine(model, params, max_new=max_new, sampler=rec).serve(
                reqs, dataclasses.replace(opts, report_cost=False))
        finally:
            setattr(paged_ops, attr, sound)
        ctrl = teacher_forced(f"serve kernel=pallas, control: {name} leaves out each "
                              "sequence's first page", model, params, reqs,
                              [r.tokens for r in rep_c.results], rec.rows, logit_tol,
                              logit_rms_tol)
        ctrl["caught_by"] = beyond(ctrl)
        print(f"  {cfg.name} serve, control: failing checks {ctrl['caught_by']}", flush=True)
        check(ctrl["caught_by"], f"{cfg.name}: the control serve passes the teacher-forced "
              "limits")
    captures = len(graph_states(eng_r))
    del rec, eng_r, rows_pallas, rows_jnp

    # the greedy serve graphed and op by op, in turns (one warm graphed
    # serve first: it captures), and the jnp kernel's graphed serve
    eng_o = op_by_op(Engine(model, params, max_new=max_new))
    jnp_opts = dataclasses.replace(opts, kernel="jnp")
    eng.serve(reqs, dataclasses.replace(opts, report_cost=False))
    eng.serve(reqs, dataclasses.replace(jnp_opts, report_cost=False))
    timing = serve_timing(f"{cfg.name} serve", reqs, [
        ("graph", eng, opts), ("op by op", eng_o, opts), ("graph", eng, opts),
        ("jnp graph", eng, jnp_opts)])
    captures += len(graph_states(eng))
    PLAIN_SERVES[arch, kv_quant]["timing"] = timing["graph"]
    print(f"  graphs captured in the phase: {captures} (one per engine and step shape: "
          f"2 engines x the kernels pallas and jnp = 4)", flush=True)
    check(captures == 4, f"{cfg.name}: {captures} graphs for 4 step shapes")
    (trace,) = traces.values()
    return {"arch": arch, "kv_pool": "int8 (absmax)" if kv_quant else "bf16", **alloc,
            "launches": n, "kernel_widths": w, "steps": rep.steps, "ties": ties,
            "teacher_forced_logits": logit_checks, "aligned_logits": aligned,
            "control": ctrl, "int8_vs_bf16_model_logits": to_bf16,
            "pool_bytes_per_token": pool_bytes, "graph_vs_op_by_op": graph_vs_op,
            "captures": captures, "timing": timing, "peak_gib": peak, "step_trace": trace}


def pool_bytes_per_token(cfg) -> int:
    """Bytes the paged KV pool of ``cfg`` holds per token, every layer."""
    from repro_torch.models import kv_cache

    pool = kv_cache.paged_cache_zeros(cfg, 1, 16, 16, 1, device="meta")
    return sum(x.numel() * x.element_size() for node in kv_cache._paged_nodes(pool)
               for k, x in node.items() if k != "table") // 16


# Phases 6, 8, 11, 16 and 17 hold the graphed serve bitwise against the
# same serve op by op on this many requests (op by op, a step costs 4-5x a
# replay; cut from 2 to keep the run inside its limit beside phase 18).
SERVE_OP_SUBSET = 1

# The checked serve of phases 6, 8 and 11 by (arch, int8 pool): its report,
# every logit row by request seed, and its warm graphed timing; phase 14
# holds its speculative serves against them.
PLAIN_SERVES = {}

# Phase 6's trace and serve options (phases 11 and 13 reuse them).
SERVE_TRACE = dict(prefix_len=384, suffix_lens=(16, 64, 128), max_new_range=(16, 64), seed=0,
                   arrival_spacing=2.0)
SERVE_OPTIONS = dict(slots=8, paged=True, block_size=16, prefix_share=True, kernel="pallas",
                     report_cost=True)


def phase6_serve(kv_quant=False):
    """Full-width olmo-1b served through Engine.serve with the paged pool,
    prefix sharing and the fused paged decode K2; ``kv_quant``: from an
    int8 pool (phase 11). Decode steps as CUDA-graph replays, held against
    the same serve op by op and timed against it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    reqs = shared_prefix_trace(32, get_config("olmo-1b").vocab, **SERVE_TRACE)
    opts = ServeOptions(**SERVE_OPTIONS)
    return serve_phase("olmo-1b", reqs, opts, fused=ops.paged_attention_rows, eager_n=1,
                       logit_tol=LOGIT_TOL, logit_rms_tol=LOGIT_RMS_TOL,
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
                       eager_n=1, logit_tol=MLA_LOGIT_TOL,
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


def zero_counters():
    from repro_torch.kernels.paged_attention import ops as paged

    for f in _kernel_counters().values():
        f.launches = 0
    paged.paged_attention_rows.int8_launches = 0


def read_counters() -> dict:
    """The wrappers' launch counts, with K2's on int8 pools."""
    from repro_torch.kernels.paged_attention import ops as paged

    n = {k: f.launches for k, f in _kernel_counters().items()}
    n["K2 on int8 pools"] = paged.paged_attention_rows.int8_launches
    return n


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
    the report, the wrappers' launches (a graphed serve's replays launch
    without the wrappers: ``path_launches``), the logit rows, the wall
    seconds and the graph replays by step shape."""
    before = replay_counts(eng)
    zero_counters()
    rec.rows = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.serve(reqs, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rep, read_counters(), rec.rows, wall, replays_in(eng, before)


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
                        CUT_LOGIT_TOL, CUT_LOGIT_RMS_TOL)
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
              "logit_max": max(tf["first_step_max"], tf["decode_max"]) > CUT_LOGIT_TOL,
              "logit_rms": tf["rms"] > CUT_LOGIT_RMS_TOL,
              "aligned_max": al["max"] > CUT_ALIGNED_TOL,
              "aligned_rms": al["rms"] > CUT_ALIGNED_RMS_TOL}
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
    """A prompt of ``n`` tokens prefilled whole and in ``chunk``-token
    prefill_tail pieces (contiguous layout, slot_prefix_view /
    slot_scatter): the share of committed K/V bytes that are equal, the
    largest difference, and the last logits' largest difference. The caller
    holds them bitwise, as the CPU tests do: the prefill pads its products
    to PREFILL_MIN_ROWS rows on the card, where cuBLAS would take a split-K
    kernel for the down projection at 128 rows and fewer and sum its
    partials in another order (``prefill_products``,
    ``probes/prefill_rows.py``)."""
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
          f"{chunk}-token prefill_tail chunks; held bitwise): "
          f"{same / total:.6f} of committed "
          f"K/V bytes equal, largest difference {diff}, last logits {logit_diff:.4g}",
          flush=True)
    return out


def prefill_products(model, params, n=512, chunk=CHUNK):
    """Chunked == whole on the card: the products of an ``n``-token prefill
    and of its ``chunk``-token pieces, at olmo-1b's widths with layer 0's
    weights and seeded bf16 inputs. Each projection, the rows of the pieces
    against the rows of the whole: whether they are bitwise equal as the
    pieces' own products give them (x @ w) and as the prefill computes them
    (``dense_apply`` under ``Model.prefill_ctx``: zero-padded to
    PREFILL_MIN_ROWS rows), the kernels each launches (torch.profiler,
    padded sessions), and the device time of one piece's product plain and
    padded (what the padding costs). The attention products of a piece (its
    queries against the keys committed so far plus its own, as ``attend``
    computes scores and PV) against the whole prefill's rows. Gate: every
    padded projection's rows equal the whole's."""
    from repro_torch.models.layers import dense_apply

    cfg = model.cfg
    lp = params["stack"]["layers"]
    g = torch.Generator("cuda").manual_seed(21)
    bf = torch.bfloat16
    ctx = model.prefill_ctx

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    products = {k: lp["attn"][k]["w"][0] for k in ("wq", "wk", "wv", "wo")}
    products.update({k: lp["ffn"][k]["w"][0] for k in ("gate", "up", "down")})
    out, calls = {}, []
    for name, w in products.items():
        x = rand(1, n, w.shape[0])
        whole = x @ w
        pieces = torch.cat([x[:, c:c + chunk] @ w for c in range(0, n, chunk)], 1)
        padded = torch.cat([dense_apply({"w": w}, x[:, c:c + chunk], ctx)
                            for c in range(0, n, chunk)], 1)
        plain_fn = lambda x=x, w=w: x[:, :chunk] @ w                        # noqa: E731
        padded_fn = lambda x=x, w=w: dense_apply({"w": w}, x[:, :chunk], ctx)  # noqa: E731
        out[name] = {"shape": [n, w.shape[0], w.shape[1]],
                     "rows_equal": bool(torch.equal(whole, pieces)),
                     "max_abs_diff": float((whole.float() - pieces.float()).abs().max()),
                     "padded_rows_equal": bool(torch.equal(whole, padded)),
                     "piece_ms": device_ms(plain_fn), "padded_piece_ms": device_ms(padded_fn)}
        calls += [(f"{name} {chunk} rows", plain_fn), (f"{name} {chunk} rows padded", padded_fn),
                  (f"{name} {n} rows", lambda x=x, w=w: x @ w)]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = rand(1, n, kv, h // kv, d), rand(1, n, kv, d), rand(1, n, kv, d)
    p = torch.rand((1, kv, h // kv, n, n), generator=g, device="cuda").to(bf)
    c0 = n - chunk                     # the last piece: chunk queries on n keys
    for name, whole_fn, piece_fn in (
            ("scores", lambda: torch.einsum("bqkgd,bskd->bkgqs", q, k)[..., c0:, :],
             lambda: torch.einsum("bqkgd,bskd->bkgqs", q[:, c0:], k)),
            ("pv", lambda: torch.einsum("bkgqs,bskd->bqkgd", p, v)[:, c0:],
             lambda: torch.einsum("bkgqs,bskd->bqkgd", p[..., c0:, :], v))):
        a, b = whole_fn(), piece_fn()
        out[name] = {"rows_equal": bool(torch.equal(a, b)),
                     "max_abs_diff": float((a.float() - b.float()).abs().max())}
        calls += [(f"{name} {chunk} rows", piece_fn), (f"{name} {n} rows", whole_fn)]
    _, kernels, _, _, _ = traced_kernels("prefill products", calls,
                                         lambda ks: all(ks.values()))
    for name, r in out.items():
        r["kernels"] = {rows: [e.name() for e in kernels[f"{name} {rows}"]]
                        for rows in (f"{chunk} rows", f"{chunk} rows padded", f"{n} rows")
                        if f"{name} {rows}" in kernels}
        padded = ("" if "padded_rows_equal" not in r else
                  f"; padded to {ctx.min_rows} rows: rows equal {r['padded_rows_equal']}, "
                  f"a piece {r['piece_ms']:.4f} ms plain, {r['padded_piece_ms']:.4f} ms padded "
                  f"(device time), kernels {r['kernels'][f'{chunk} rows padded']}")
        print(f"  prefill product {name} ({n} tokens against {chunk}-token pieces): piece "
              f"rows bitwise equal {r['rows_equal']} (max diff {r['max_abs_diff']:.4g}); "
              f"kernels at {chunk} rows {r['kernels'][f'{chunk} rows']}, at {n} rows "
              f"{r['kernels'][f'{n} rows']}{padded}", flush=True)
    check(all(r.get("padded_rows_equal", True) for r in out.values()),
          f"prefill products padded to {ctx.min_rows} rows differ from the whole's: "
          f"{[k for k, r in out.items() if not r.get('padded_rows_equal', True)]}")
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
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"), n_layers=OLMO_CUT_LAYERS)
    params = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    print(f"chunked prefill and preemption: {cfg.name} full width, {cfg.n_layers} of its 16 "
          f"layers, bf16 seeded weights, "
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
        label = f"chunked + preempting serve, {pool} pool"
        rec = _LogitRecorder()
        eng = Engine(model, params, max_new=64, sampler=rec)
        rep, counted, rows, first_s, replayed = counted_serve(eng, reqs, opts, rec)
        rec_o = _LogitRecorder()
        eng_o = op_by_op(Engine(model, params, max_new=64, sampler=rec_o))
        rep_o, n_o, rows_o, _, _ = counted_serve(eng_o, reqs, opts, rec_o)
        graph_vs_op = serve_graph_vs_op(label, reqs, (rep, rows, eng), (rep_o, rows_o, eng_o))
        del eng_o, rec_o, rows_o
        plain, counted_p, rows_p, _, replayed_p = counted_serve(eng, reqs, plain_opts, rec)
        # the replays of both step shapes (chunked, plain) traced in one session
        per_replay = {k: 0 for k in counted}
        per_replay["K2"] = cfg.n_layers
        if kv_quant:
            per_replay["K2 on int8 pools"] = cfg.n_layers
        traces = replay_trace(label, replayed_graphs(eng, replayed, replayed_p))
        n = path_launches(label, counted, replayed, traces, per_replay)
        n_p = path_launches(f"{label}, plain serve", counted_p, replayed_p, traces, per_replay)
        same_launches(label, graph_vs_op, n, n_o)
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
        # chunked == whole on the card (the prefill pads its products), and
        # decode rows independent of the step's other slots: the chunked,
        # preempting serve equals the plain one bitwise
        same = (not stats["divergences"] and stats["aligned"]["max"] == 0.0 and all(
            np.array_equal(a.tokens, b.tokens) for a, b in zip(rep.results, plain.results)))
        print(f"  chunked + preempting serve == plain serve, {pool} pool, bitwise (tokens and "
              f"every step-aligned logit row): {same}", flush=True)
        check(same, f"phase 13, {pool} pool: the chunked, preempting serve differs from the "
              f"plain serve: {stats['aligned']}, {len(stats['divergences'])} divergences")
        run = {"gates": gates, "equals_plain_bitwise": same, **info, "launches": n, "plain_launches": n_p,
               "steps": rep.steps, "preemptions": rep.preemptions, "resumes": rep.resumes,
               "evictions": rep.evictions, "max_prefill_per_step": rep.max_prefill_per_step,
               "plain_max_prefill_per_step": plain.max_prefill_per_step,
               "swap_round_trip": rt, **stats}
        # 2048 tokens in 256-token chunks, and this phase's own 128-token
        # chunks of a 512-token prompt
        run["whole_vs_chunked_prefill"] = [whole_vs_chunked_prefill(model, params),
                                           whole_vs_chunked_prefill(model, params, 512, 128)]
        for w in run["whole_vs_chunked_prefill"]:
            check(w["equal_byte_share"] == 1.0 and w["last_logits_max_abs_diff"] == 0.0,
                  f"phase 13, {pool} pool: whole and chunked prefill differ: {w}")
        if not kv_quant:
            run["prefill_products"] = prefill_products(model, params)
        run["graph_vs_op_by_op"] = graph_vs_op
        run["step_trace"] = traces[next(iter(replayed))]
        # the greedy serves graphed (chunked and plain) and the chunked one op
        # by op, in turns (one warm graphed serve of each shape first: it
        # captures); the bf16 pool's plain serve twice, the int8 pool's once
        eng_t = Engine(model, params, max_new=64)
        for o in (opts, plain_opts):
            eng_t.serve(reqs, dataclasses.replace(o, report_cost=False))
        eng_to = op_by_op(Engine(model, params, max_new=64))
        plan = [("chunked", eng_t, opts), ("op by op", eng_to, opts),
                ("chunked", eng_t, opts), ("plain", eng_t, plain_opts)]
        if not kv_quant:
            plan.insert(0, ("plain", eng_t, plain_opts))
        run["timing"] = serve_timing(label, reqs, plan, graph="chunked")
        del eng_to
        run["captures"] = len(graph_states(eng, eng_t))
        print(f"  graphs captured, {pool} pool: {run['captures']} (one per engine and step "
              f"shape: 2 engines x the shapes chunked and plain = 4)", flush=True)
        check(run["captures"] == 4, f"phase 13, {pool} pool: {run['captures']} graphs for 4 "
              "step shapes")
        out["runs"][pool] = run
        del eng, rec, rows, rows_p
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13 in {out['seconds']:.1f} s ({card_line()})", flush=True)
    return out


# ----------------------------------------------------------------- phase 14

# Speculative serving: n-gram drafts of SPEC_K tokens a round on phase 6's
# and phase 8's traces and options. The chunked composition and the
# draft-model runs take the first SPEC_SUBSET requests; the graph-vs-op-by-
# op comparison (with the rollback read) the first SPEC_OP_SUBSET of them,
# MLA's the first MLA_SPEC_OP_SUBSET: op by op, these are the phase's
# costliest runs (cut from 8 to 2 requests to fit the phase's budget, and
# to 1 beside phase 18).
SPEC_K = 4
SPEC_SUBSET = 8
SPEC_OP_SUBSET = 1
MLA_SPEC_OP_SUBSET = 1
DRAFT_LAYERS = 2
# phase 8's trace, every fourth request in class 0 and the rest in class 1,
# chunked and preempting from a pool this tight: one preemption (the
# schedule depends on the trace alone; 90 blocks livelock, ROADMAP.md
# Queue 3)
MLA_POOL_BLOCKS = 110


class SpecRecorder:
    """Every served logit row of a speculative serve through ``eng``, by the
    seed of the request's generator: the first token's (the prefill's, which
    ``eng.sample`` draws greedily) and each verify round's rows that emitted
    a token (``Engine._serve_decode`` gives the round's logits beside n_emit).
    ``rollback``: after every round, read the state's cache at each live
    slot's rejected positions (``pos + n_emit .. pos + K``, those inside the
    cache and the slot's blocks) and count the entries that are not zero
    bitwise — run op by op, so the cache is the round's own. ``detach``
    gives the engine back its own sampler and serve step."""

    def __init__(self, eng, rollback=False):
        self.rows, self.rollback = {}, {"positions": 0, "nonzero": 0, "rounds": 0}
        self.eng, self.sample = eng, eng.sample
        orig = eng._serve_decode

        def sample(logits, generator):
            self.rows.setdefault(generator.initial_seed(), []).append(logits[0].clone())
            return torch.argmax(logits, dim=-1).to(torch.int32)

        def serve_decode(st, host_inputs, generators):
            packed, logits = orig(st, host_inputs, generators)
            n_emit = packed[:, -1]
            for s, g in enumerate(generators):
                if g is not None:
                    self.rows.setdefault(g.initial_seed(), []).extend(
                        logits[s, :int(n_emit[s])].clone())
            if rollback:
                self._check(st, host_inputs, generators, n_emit)
            return packed, logits

        eng.sample = sample
        eng._serve_decode = serve_decode

    def detach(self):
        self.eng.sample = self.sample
        del self.eng._serve_decode

    def _check(self, st, host_inputs, generators, n_emit):
        t = host_inputs.shape[1] - 1
        table = st.cache["table"][0].cpu().numpy()
        pools = [v for k, v in st.cache.items() if k != "table"]
        nb, bs = pools[0].shape[1:3]
        c = table.shape[1] * bs
        pbs, offs = [], []
        for s, g in enumerate(generators):
            if g is None:
                continue
            for p in range(int(host_inputs[s, t]) + int(n_emit[s]), int(host_inputs[s, t]) + t):
                if p < c and table[s, p // bs] < nb:
                    pbs.append(int(table[s, p // bs]))
                    offs.append(p % bs)
        self.rollback["rounds"] += 1
        if pbs:
            ib = torch.as_tensor(pbs, device=pools[0].device)
            io = torch.as_tensor(offs, device=pools[0].device)
            self.rollback["positions"] += len(pbs)
            self.rollback["nonzero"] += sum(int((leaf[:, ib, io] != 0).sum()) for leaf in pools)

    def trimmed(self, reqs):
        """The rows of the tokens each request kept (a round's emissions past
        the budget are recorded, then dropped by the host)."""
        return {r.seed: self.rows.get(r.seed, [])[:r.max_new] for r in reqs}


class KernelWidths:
    """While active, records (query block width T, query rows) of every call
    of the fused paged attention wrappers (K2: rows T x group; K4: T x H),
    capture-time calls included: a replay repeats the captured call."""

    def __enter__(self):
        from repro_torch.kernels.paged_attention import ops

        self.ops, self.calls = ops, {"K2": [], "K4": []}
        self.orig = (ops.paged_attend_dense, ops.paged_attend_mla)
        dense, mla = self.orig

        def k2(q, k_pool, *args, **kw):
            self.calls["K2"].append((q.shape[1], q.shape[1] * q.shape[2] // k_pool.shape[2]))
            return dense(q, k_pool, *args, **kw)

        def k4(q_lat, *args, **kw):
            self.calls["K4"].append((q_lat.shape[1], q_lat.shape[1] * q_lat.shape[2]))
            return mla(q_lat, *args, **kw)

        ops.paged_attend_dense, ops.paged_attend_mla = k2, k4
        return self

    def __exit__(self, *exc):
        self.ops.paged_attend_dense, self.ops.paged_attend_mla = self.orig

    def widths(self, kernel):
        return sorted(set(self.calls[kernel]))


def plain_serve(arch, kv_quant, model, params, reqs, opts):
    """The plain serve of ``reqs``: phase 8's checked serve (report, logit
    rows, warm graphed timing) when this process ran it (``arch``: its key
    in PLAIN_SERVES), else a fresh one (no timing): phase 14's olmo-1b runs
    at OLMO_CUT_LAYERS, not phase 6's and 11's depth."""
    from repro_torch.serving.engine import Engine

    got = PLAIN_SERVES.get((arch, kv_quant))
    if got is not None:
        return got["rep"], got["rows"], got.get("timing")
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=max(r.max_new for r in reqs), sampler=rec)
    rep, _, rows, _, _ = counted_serve(eng, reqs, opts, rec)
    return rep, rows, None


def spec_cost_gates(eng, rep, opts, draft_round):
    """The speculative serve's meter: per-request shares sum to the batch
    meter, the verify phase is the verify step's meter times the rounds,
    the draft phase the proposer's round meter times the rounds (zero for
    n-gram drafts), and the prefills are the rest (name -> passed)."""
    from repro_torch.backends import ZERO_COST

    geom = (opts.block_size, opts.num_blocks or eng._last_alloc.num_blocks)
    verify = eng._meter_serve_step(opts.slots, rep.cache_len, geom, t=opts.draft_k + 1)
    draft = draft_round or ZERO_COST

    def close(a, b):
        return all(abs(float(getattr(a, f)) - float(getattr(b, f)))
                   <= 1e-9 * max(abs(float(getattr(b, f))), 1e-30)
                   for f in ("vectors", "cycles", "latency_s", "energy_j"))

    rest = float(rep.cost.cycles) - float(rep.cost_verify.cycles) - float(rep.cost_draft.cycles)
    return {"cost_shares": cost_shares_sum(rep),
            "verify_phase": close(rep.cost_verify, verify.scaled(rep.steps)),
            "draft_phase": close(rep.cost_draft, draft.scaled(rep.steps)),
            "prefill_rest": 0 < rest < float(rep.cost.cycles)}


def spec_serve_checks(label, model, params, reqs, rep, rows, plain, plain_rows, tols):
    """A speculative serve against the plain serve of its trace: greedy
    tokens and every served logit row bitwise equal to the plain serve's
    (a verify block's rows get the decode step's bits: K2 and K4 split
    them at the decode step's chunks, and the down projection and the norms
    pad both to one row count), and every served logit row within the teacher-forced
    limits (``tols``: phase 6's or phase 8's). Returns the statistics;
    fails on a check that does not hold."""
    logit_tol, rms_tol, aligned_tol, aligned_rms_tol = tols
    base = plain.by_rid()
    ties = []
    for a in rep.results:
        compare_tokens(f"{label} vs plain, request {a.rid}", a.tokens, base[a.rid].tokens,
                       a.prompt_len, model, params, ties)
    tf = teacher_forced(label, model, params, reqs, [r.tokens for r in rep.results], rows,
                        logit_tol, rms_tol)
    check(max(tf["first_step_max"], tf["decode_max"]) <= logit_tol and tf["rms"] <= rms_tol,
          f"{label}: served logits differ from the teacher-forced pass beyond the limits: {tf}")
    al = aligned_logits(f"{label} vs plain", reqs, rep.results,
                        [base[a.rid] for a in rep.results], rows, plain_rows)
    check(al["max"] <= aligned_tol and al["rms"] <= aligned_rms_tol,
          f"{label}: logits differ from the plain serve's step by step beyond the limits "
          f"({aligned_tol}, RMS {aligned_rms_tol}): {al}")
    same = (not ties and all(np.array_equal(a.tokens, base[a.rid].tokens) for a in rep.results)
            and rows_equal(rows, {r.seed: plain_rows[r.seed] for r in reqs}) == len(reqs))
    print(f"  {label}: greedy tokens == plain serve's for {len(reqs) - len(ties)} of "
          f"{len(reqs)} requests ({len(ties)} near-tie divergences); bitwise equal to the "
          f"plain serve (tokens, every logit row): {same}", flush=True)
    check(same, f"{label}: the speculative serve differs from the plain serve: {len(ties)} "
          f"divergences, step-aligned logits {al}")
    return {"ties": ties, "teacher_forced": tf, "aligned": al, "equals_plain_bitwise": same}


def spec_run(label, model, params, reqs, opts, plain, plain_rows, tols, kernel, int8=False):
    """One checked speculative serve (graphed): launches (the wrappers' plus
    each replay's kernels from the device trace: ``kernel`` n_layers a
    replay, K2 on int8 pools with ``int8``, nothing else), every call of
    the fused kernel at T = K + 1, K1 n_layers x the prefills, no leaked
    blocks, the meter's gates, and ``spec_serve_checks``. Returns (record,
    engine (its graph kept), logit rows, report)."""
    from repro_torch.serving.engine import Engine

    n_layers = model.cfg.n_layers
    eng = Engine(model, params, max_new=max(r.max_new for r in reqs))
    rec = SpecRecorder(eng)
    with KernelWidths() as widths:
        rep, counted, _, first_s, replayed = counted_serve(eng, reqs, opts, rec)
    rows = rec.trimmed(reqs)
    rec.detach()
    check(len(rep.results) == len(reqs) and all(
        res.tokens.shape == (r.prompt_len + r.max_new,) for r, res in zip(reqs, rep.results)),
        f"{label}: not every request completed")
    check(rep.leaked_blocks == 0, f"{label}: {rep.leaked_blocks} pool blocks leaked")
    gates = spec_cost_gates(eng, rep, opts, None)
    check(all(gates.values()), f"{label}: meter gates {gates}")
    per_replay = {k: 0 for k in counted}
    per_replay[kernel] = n_layers
    if int8:
        per_replay["K2 on int8 pools"] = n_layers
    traces = replay_trace(label, replayed_graphs(eng, replayed))
    n = path_launches(label, counted, replayed, traces, per_replay)
    want = {k: 0 for k in n}
    want.update({"K1": n_layers * len(reqs), kernel: n_layers * rep.steps})
    if int8:
        want["K2 on int8 pools"] = n_layers * rep.steps
    t = opts.draft_k + 1
    group = (model.cfg.n_heads if kernel == "K4" else
             model.cfg.n_heads // model.cfg.n_kv_heads)
    w = widths.widths(kernel)
    tokens = sum(r.max_new for r in reqs)
    print(f"{label}: {rep.steps} rounds against the plain serve's {plain.steps} steps "
          f"({tokens} tokens, {tokens / rep.steps:.3f} a round), drafted "
          f"{rep.drafted_tokens}, accepted {rep.accepted_tokens}, acceptance rate "
          f"{rep.acceptance_rate:.4f}; launches {n} (expected {want}); {kernel} calls at "
          f"(T, rows) {w} (expected [({t}, {t * group})]); meter gates {gates}; first serve "
          f"{first_s:.2f} s", flush=True)
    check(n == want, f"{label}: kernel launches {n} != {want}")
    check(w == [(t, t * group)], f"{label}: {kernel} ran at (T, rows) {w}")
    stats = spec_serve_checks(label, model, params, reqs, rep, rows, plain, plain_rows, tols)
    (trace,) = traces.values()
    return ({"rounds": rep.steps, "plain_steps": plain.steps, "tokens": tokens,
             "tokens_per_round": tokens / rep.steps, "drafted": rep.drafted_tokens,
             "accepted": rep.accepted_tokens, "acceptance_rate": rep.acceptance_rate,
             "launches": n, "kernel_widths": w, "meter_gates": gates, "step_trace": trace,
             "first_serve_s": first_s, **stats}, eng, rows, rep)


def spec_graph_vs_op(label, model, params, reqs, opts, per_replay):
    """The speculative serve of ``reqs`` graphed against the same serve op
    by op: tokens, every logit row, pool bytes and launches bitwise equal
    (``serve_graph_vs_op``; the graphed launches from ``per_replay``, the
    kernel calls of a replay of this step shape in the device trace); the
    op-by-op run reads every round's rejected positions in the pool,
    which must be zero bitwise (the rollback)."""
    from repro_torch.serving.engine import Engine

    max_new = max(r.max_new for r in reqs)
    eng_g = Engine(model, params, max_new=max_new)
    rec_g = SpecRecorder(eng_g)
    rep_g, n_g, _, _, replayed = counted_serve(eng_g, reqs, opts, rec_g)
    eng_o = op_by_op(Engine(model, params, max_new=max_new))
    rec_o = SpecRecorder(eng_o, rollback=True)
    rep_o, n_o, _, _, _ = counted_serve(eng_o, reqs, opts, rec_o)
    rec = serve_graph_vs_op(label, reqs, (rep_g, rec_g.trimmed(reqs), eng_g),
                            (rep_o, rec_o.trimmed(reqs), eng_o))
    n = path_launches(label, n_g, replayed, {k: {"calls_per_replay": per_replay}
                                              for k in replayed}, per_replay)
    same_launches(label, rec, n, n_o)
    rb = rec_o.rollback
    print(f"  rollback, {label}, op by op: {rb['rounds']} rounds, {rb['positions']} rejected "
          f"positions read in the pool, {rb['nonzero']} entries not zero", flush=True)
    check(rb["positions"] > 0 and rb["nonzero"] == 0,
          f"{label}: rejected drafts left K/V behind: {rb}")
    return {**rec, "rollback": rb}


def spec_timing(label, eng, reqs, spec, plain_timing, runs=2):
    """``runs`` warm greedy speculative serves through ``eng`` (its round already
    captured) on the host clock: ms per round (wall / rounds, prefills
    included), generated tok/s, the aten ops per replayed round, beside
    the plain serve's warm graphed serves of this call (phase 6). Gate: at
    most MAX_REPLAYED_STEP_OPS ops a replayed round."""
    import dataclasses

    tokens = sum(r.max_new for r in reqs)
    walls = []
    with StepOps("_serve_decode") as ops:
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = eng.serve(reqs, dataclasses.replace(spec, report_cost=False))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    out = {"walls_ms": [w * 1e3 for w in walls], "rounds": rep.steps,
           "ms_per_round": med * 1e3 / rep.steps, "tok_s": tokens / med,
           "aten_ops_per_replayed_round": ops.per_step, "plain": plain_timing}
    plain = ("" if plain_timing is None else
             f"; the plain serve (this call): {plain_timing['ms_per_step']:.3f} ms "
             f"per step x {plain_timing['steps']} steps, {plain_timing['tok_s']:.1f} tok/s")
    print(f"  {label}, warm serves: walls {[round(x, 1) for x in out['walls_ms']]} ms, "
          f"{out['ms_per_round']:.3f} ms per round x {rep.steps} rounds (prefills included), "
          f"{out['tok_s']:.1f} generated tok/s{plain}; host work per round: "
          f"{ops.per_step:.1f} aten ops replayed (limit {MAX_REPLAYED_STEP_OPS}) "
          f"({card_line()})", flush=True)
    check(ops.per_step <= MAX_REPLAYED_STEP_OPS,
          f"{label}: {ops.per_step} aten ops per replayed round")
    return out


def phase14_speculative():
    """Speculative serving through Engine.serve at full width (phase 14):
    olmo-1b with n-gram drafts from the bf16 and the int8 pool, composed
    with chunked prefill, with a two-layer olmo-1b draft model and with
    itself as draft; minicpm3-4b with n-gram drafts; then minicpm3-4b
    chunked and preempting (item 9's card leftover). olmo-1b runs at
    OLMO_CUT_LAYERS against its own plain serves; minicpm3-4b against phase
    8's."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    t_phase = time.perf_counter()
    card = card_line()
    spec = ServeOptions(**SERVE_OPTIONS, speculative=True, draft="ngram", draft_k=SPEC_K)
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"), n_layers=OLMO_CUT_LAYERS)
    reqs = shared_prefix_trace(32, cfg.vocab, **SERVE_TRACE)
    sub = reqs[:SPEC_SUBSET]
    params = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    tols = (CUT_LOGIT_TOL, CUT_LOGIT_RMS_TOL, CUT_ALIGNED_TOL, CUT_ALIGNED_RMS_TOL)
    print(f"speculative serve: {cfg.name} full width, {cfg.n_layers} of its 16 layers, bf16 "
          f"seeded weights, softmax "
          f"int_pallas; phase 6's trace of {len(reqs)} requests and options plus speculative, "
          f"n-gram drafts of {SPEC_K} tokens ({card})", flush=True)
    out = {"draft_k": SPEC_K, "runs": {}}
    for kv_quant in (False, True):
        pool = "int8 (absmax)" if kv_quant else "bf16"
        model = Model(dataclasses.replace(cfg, kv_quant=kv_quant))
        label = f"olmo-1b spec serve, {pool} pool"
        plain, plain_rows, plain_timing = plain_serve(
            ("olmo-1b", cfg.n_layers), kv_quant, model, params, reqs,
            ServeOptions(**SERVE_OPTIONS))
        run, eng, rows, rep = spec_run(label, model, params, reqs, spec, plain, plain_rows,
                                       tols, "K2", int8=kv_quant)
        sub_spec = dataclasses.replace(spec, report_cost=False)
        if not kv_quant:
            run["timing"] = spec_timing(label, eng, reqs, spec, plain_timing)
            # composed with chunked prefill: the first requests served with
            # prefill_chunk, bitwise equal to the same requests of the run
            # above
            rec = SpecRecorder(eng)
            chunked = counted_serve(eng, sub, dataclasses.replace(sub_spec, prefill_chunk=CHUNK),
                                    rec)[0]
            rec.detach()
            comp = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                                  for a, b in zip(chunked.results, rep.results)),
                    "logit_rows": rows_equal(rec.trimmed(sub),
                                             {r.seed: rows[r.seed] for r in sub}) == len(sub),
                    "max_prefill_per_step": chunked.max_prefill_per_step}
            print(f"  spec serve + prefill_chunk {CHUNK}, first {SPEC_SUBSET} requests, == the "
                  f"spec serve's rows of them, bitwise: {comp}", flush=True)
            check(comp["tokens"] and comp["logit_rows"] and
                  comp["max_prefill_per_step"] <= CHUNK,
                  f"{label}: chunked prefill changes the speculative serve: {comp}")
            run["chunked_composition"] = comp
        run["graph_vs_op_by_op"] = spec_graph_vs_op(
            f"{label}, first {SPEC_OP_SUBSET} requests", model, params, reqs[:SPEC_OP_SUBSET],
            sub_spec, run["step_trace"]["calls_per_replay"])
        if not kv_quant:
            run["draft_model"] = spec_draft_model(model, params, sub, sub_spec, plain,
                                                  plain_rows)
        del eng, rows, rep, plain_rows
        out["runs"][pool] = run
    out["runs"]["minicpm3-4b"] = spec_mla()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 14 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


def spec_draft_model(model, params, reqs, spec, plain, plain_rows):
    """olmo-1b served speculatively with a draft model, its proposal steps
    CUDA-graph replays: olmo-1b's config at DRAFT_LAYERS layers with its own
    seeded weights (the same vocab), then the target as its own draft,
    whose proposals the verifier accepts but at near ties (rounds of
    several emissions, the catch-up step). Tokens and logits as the n-gram
    serve's checks; K1 launches: n_layers x the target's prefills, plus the
    draft's layers x its prefills; K2: n_layers x rounds, plus the draft's
    layers x its decode steps (K a round, plus at most one catch-up step a
    round), each replay's kernels counted in
    one device trace of both runs' graphs. The draft decodes through the
    serve's kernel (K2 over its stripes seen as a pool), so the target as
    its own draft proposes the target's tokens: acceptance exactly 1."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    dcfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"), n_layers=DRAFT_LAYERS)
    small = Model(dcfg)
    drafts = {f"draft model ({dcfg.n_layers} layers)":
              (small, small.init(torch.Generator("cuda").manual_seed(1))),
              "the target as its own draft": (model, params)}
    runs, graphs = {}, {}
    for name, (draft, dparams) in drafts.items():
        opts = dataclasses.replace(spec, draft="model", draft_model=draft,
                                   draft_params=dparams, report_cost=True)
        eng = Engine(model, params, max_new=64)
        rec = SpecRecorder(eng)
        rep, counted, _, _, replayed = counted_serve(eng, reqs, opts, rec)
        (proposer, _, _), = eng._proposers.values()
        (dstate,) = proposer._states.values()
        # the serve's proposal-step replays, read before the device trace
        # below replays each graph again
        runs[name] = (draft, opts, eng, rep, counted, replayed, rec.trimmed(reqs), proposer,
                      dstate.graph.replays)
        for k in replayed:
            graphs[f"{name}: verify round"] = eng._decode_states[k].graph
        graphs[f"{name}: proposal step"] = dstate.graph
    traces = replay_trace("olmo-1b spec serve, draft models", graphs)
    out = {}
    for name, (draft, opts, eng, rep, counted, replayed, rows, proposer, draft_replays) in \
            runs.items():
        label = f"olmo-1b spec serve, {name}, first {len(reqs)} requests"
        check(rep.leaked_blocks == 0 and len(rep.results) == len(reqs),
              f"{label}: leaked blocks or lost requests")
        gates = spec_cost_gates(eng, rep, opts, proposer.meter_round())
        check(all(gates.values()), f"{label}: meter gates {gates}")
        per_replay = {k: 0 for k in counted}
        per_replay["K2"] = model.cfg.n_layers
        n = path_launches(label, counted, replayed,
                          {k: traces[f"{name}: verify round"] for k in replayed}, per_replay)
        dlayers = draft.cfg.n_layers
        dcalls = traces[f"{name}: proposal step"]["calls_per_replay"]
        check(dcalls == {**{k: 0 for k in dcalls}, "K2": dlayers},
              f"{label}: the draft step's kernel calls per replay {dcalls}")
        draft_steps = 1 + draft_replays                 # the warm-up step, then replays
        n["K2"] += draft_replays * dlayers
        want_k1 = (model.cfg.n_layers + dlayers) * len(reqs)
        want_k2 = model.cfg.n_layers * rep.steps + dlayers * draft_steps
        catch_ups = draft_steps - SPEC_K * rep.steps
        print(f"{label}: {rep.steps} rounds, acceptance rate {rep.acceptance_rate:.4f} "
              f"(drafted {rep.drafted_tokens}, accepted {rep.accepted_tokens}); draft decode "
              f"steps {draft_steps} = {SPEC_K} x {rep.steps} rounds + {catch_ups} catch-ups; "
              f"launches {n} (K1 expected {want_k1} = ({model.cfg.n_layers} + {dlayers}) x "
              f"{len(reqs)} target and draft prefills, K2 {want_k2} = {model.cfg.n_layers} x "
              f"{rep.steps} rounds + {dlayers} x {draft_steps} draft steps); meter gates "
              f"{gates}", flush=True)
        check(n["K1"] == want_k1 and 0 <= catch_ups <= rep.steps and n["K2"] == want_k2,
              f"{label}: launches {n}, draft steps {draft_steps}")
        if draft is model:
            check(rep.acceptance_rate == 1.0, f"{label}: the target as its own draft "
                  f"accepted {rep.acceptance_rate:.4f} of its proposals, not all")
        stats = spec_serve_checks(label, model, params, reqs, rep, rows, plain, plain_rows,
                                  (CUT_LOGIT_TOL, CUT_LOGIT_RMS_TOL, CUT_ALIGNED_TOL,
                                   CUT_ALIGNED_RMS_TOL))
        out[name] = {"draft_layers": dlayers, "rounds": rep.steps,
                     "acceptance_rate": rep.acceptance_rate, "draft_steps": draft_steps,
                     "catch_ups": catch_ups, "launches": n, "meter_gates": gates,
                     "verify_round_trace": traces[f"{name}: verify round"],
                     "proposal_step_trace": traces[f"{name}: proposal step"], **stats}
    return out


def spec_mla():
    """minicpm3-4b served speculatively (n-gram drafts) on phase 8's trace
    and options, K4 at T = K + 1 (200 query rows), against phase 8's plain
    serve; then the trace with priorities, chunked and preempting (not
    speculative), against the same plain serve, bitwise."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    model = Model(get_config("minicpm3-4b", softmax=SoftmaxSpec("int_pallas")))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    reqs = _mla_trace()
    plain_opts = ServeOptions(slots=MLA_SLOTS, paged=True, block_size=MLA_BS,
                              prefix_share=True, kernel="pallas", report_cost=True)
    spec = dataclasses.replace(plain_opts, speculative=True, draft="ngram", draft_k=SPEC_K)
    plain, plain_rows, _ = plain_serve("minicpm3-4b", False, model, params, reqs, plain_opts)
    label = "minicpm3-4b spec serve"
    run, eng, rows, _ = spec_run(
        label, model, params, reqs, spec, plain, plain_rows,
        (MLA_LOGIT_TOL, MLA_LOGIT_RMS_TOL, MLA_ALIGNED_TOL, MLA_ALIGNED_RMS_TOL), "K4")
    del eng, rows
    run["graph_vs_op_by_op"] = spec_graph_vs_op(
        f"{label}, first {MLA_SPEC_OP_SUBSET} requests", model, params,
        reqs[:MLA_SPEC_OP_SUBSET], dataclasses.replace(spec, report_cost=False),
        run["step_trace"]["calls_per_replay"])
    # item 9's leftover: MLA chunked prefill and preemption on the card
    prio = [dataclasses.replace(r, priority=0 if r.rid % 4 == 0 else 1) for r in reqs]
    rec = _LogitRecorder()
    ch, _, ch_rows, _, _ = counted_serve(
        Engine(model, params, max_new=32, sampler=rec), prio,
        dataclasses.replace(plain_opts, prefill_chunk=CHUNK, preemption=True,
                            num_blocks=MLA_POOL_BLOCKS), rec)
    al = aligned_logits("minicpm3-4b chunked + preempting vs plain", prio, ch.results,
                        plain.results, ch_rows, plain_rows)
    same = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                          for a, b in zip(ch.results, plain.results)),
            "logit_rows": rows_equal(ch_rows, {r.seed: plain_rows[r.seed] for r in prio})
            == len(prio),
            "preempted": ch.preemptions >= 1 and ch.resumes == ch.preemptions,
            "no_leaked_blocks": ch.leaked_blocks == 0,
            "prefill_per_step": ch.max_prefill_per_step <= CHUNK}
    print(f"  minicpm3-4b chunked (prefill_chunk {CHUNK}) + preempting serve, every fourth "
          f"request in class 0, pool of {MLA_POOL_BLOCKS} blocks: {ch.steps} steps (plain "
          f"{plain.steps}), preemptions {ch.preemptions}, resumes {ch.resumes}, max prompt "
          f"tokens in a step {ch.max_prefill_per_step}; == the plain serve (phase 8) bitwise: "
          f"{same}", flush=True)
    check(all(same.values()), f"minicpm3-4b chunked + preempting serve: {same}, {al}")
    run["chunked_preempting"] = {**same, "steps": ch.steps, "preemptions": ch.preemptions,
                                 "resumes": ch.resumes, "aligned": al}
    return run

# ----------------------------------------------------------------- phase 15

# The softmax-variant zoo and the functional AP simulator through
# Engine.serve at olmo-1b's full width: phase 6's trace cut to
# VARIANT_REQUESTS requests, its options with kernel="jnp" (the fused paged
# kernels run Alg. 1 only); the graph-vs-op-by-op comparison takes the first
# VARIANT_OP_REQUESTS of them, the eager comparison and the learnable
# ConSmax serve the first VARIANT_EAGER_REQUESTS (op by op, the phase's
# costliest runs: cut from 2 to keep the phase near 60 s, and the graph
# comparison from 2 to 1 beside phase 18).
VARIANTS = ("consmax", "sole", "mive")
VARIANT_REQUESTS = 8
VARIANT_OP_REQUESTS = 1
VARIANT_EAGER_REQUESTS = 1
# A variant's probabilities on the card against its plain version on the
# CPU, on the same f32 scores: the integer codes are bitwise (ConSmax's exp
# codes), the float steps around them are each an IEEE operation but for
# exp (ConSmax's straight-through y_fp), exp2 and log2 (SOLE's and MIVE's
# reciprocals), whose card and CPU versions may differ by an ulp or two. A
# probability (at most gamma = 1 here) may differ by 2^-20, 8 f32 ulps at 1.
VARIANT_CARD_CPU_TOL = 2.0 ** -20
# The variants' serves against the teacher-forced pass, olmo-1b at
# OLMO_CUT_LAYERS (the run's budget, as phases 13 and 14): phase 6's rule
# at 1.3 times the largest reading at that depth on the H100 (mive: max
# 0.08594, RMS 0.01516; sole 0.0625 / 0.01064, consmax 0.03125 / 0.005002;
# PERF.md §6). At 16 layers mive read 0.1094 / 0.01836 against phase
# 6's 0.25 / 0.02.
VARIANT_LOGIT_TOL, VARIANT_LOGIT_RMS_TOL = 1.3 * 0.08594, 1.3 * 0.01516
# ap_sim's serve: AP_REQUESTS requests of AP_PROMPT random tokens, AP_NEW
# new tokens each (the simulator runs on the host, every decode step op by
# op).
AP_REQUESTS, AP_PROMPT, AP_NEW = 2, 64, 8


def _tree_np(tree):
    """A parameter tree of tensors as numpy f32 arrays (the reference's
    layout, which ``convert.params_from_numpy`` reads)."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.float().cpu().numpy()


def prefill_layer_scores(model, params, n=512):
    """The f32 attention scores [1, KV, G, n, n] of layer 0 of ``model``'s
    prefill of an n-token prompt, as ``attention.attend`` forms them, and
    their causal mask."""
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.models.attention import _SCORE_DTYPES, project_qkv
    from repro_torch.models.layers import norm_apply, positions_for
    from repro_torch.models.transformer import layer_params

    cfg = model.cfg
    prompt = SyntheticCorpus(cfg.vocab, seed=1234).sample(1, n, seed=777)[:, :n]
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")
    p = layer_params(params["stack"]["layers"], 0)
    h = norm_apply(p["norm1"], model._embed(params, tokens), cfg.norm, model.ctx)
    q, k, _ = project_qkv(p["attn"], h, cfg, model.ctx,
                          positions_for(tokens.shape, device="cuda"))
    kv, dh = cfg.n_kv_heads, cfg.d_head
    qg = q.reshape(1, n, kv, cfg.n_heads // kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(
        _SCORE_DTYPES[cfg.scores_dtype]).float() * dh ** -0.5
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device="cuda"))
    return scores, mask


def variants_card_vs_cpu(model, params):
    """Each variant on one full-width prefill layer's scores on the card
    against the port's plain version of the same scores on the CPU:
    ConSmax's integer exp codes bitwise, every variant's probabilities
    within VARIANT_CARD_CPU_TOL; ap_sim (the functional AP simulator, a
    host round trip) against ``int`` (plain torch Alg. 1) on the card,
    bitwise."""
    from repro_torch.backends import get_backend
    from repro_torch.core.softmax_variants import consmax_codes

    scores, mask = prefill_layer_scores(model, params)
    m = mask[None, None, None]
    out = {"scores_shape": list(scores.shape)}
    codes = consmax_codes(scores)
    codes_cpu = consmax_codes(scores.cpu())
    out["consmax_codes_differing"] = int((codes.cpu() != codes_cpu).sum())
    for kind in VARIANTS:
        b = get_backend(kind)
        card, cpu = b.apply(scores, mask=m), b.apply(scores.cpu(), mask=m.cpu())
        d = (card.cpu() - cpu).abs()
        out[kind] = {"max_abs_diff": float(d.max()), "differing": int((d > 0).sum())}
    ap = get_backend("ap_sim").apply(scores, mask=m)
    alg1 = get_backend("int").apply(scores, mask=m)
    out["ap_sim_vs_int_differing"] = int((ap != alg1).sum())
    print(f"  variants on olmo-1b's layer-0 prefill scores {out['scores_shape']} (512 tokens, "
          f"causal), card vs CPU: consmax codes differing {out['consmax_codes_differing']} "
          f"of {codes.numel()}; probabilities "
          f"{ {k: out[k] for k in VARIANTS} } (limit {VARIANT_CARD_CPU_TOL:.3g}); ap_sim vs "
          f"int on the card: {out['ap_sim_vs_int_differing']} probabilities differ",
          flush=True)
    check(out["consmax_codes_differing"] == 0, "consmax codes differ between card and CPU")
    for kind in VARIANTS:
        check(out[kind]["max_abs_diff"] <= VARIANT_CARD_CPU_TOL,
              f"{kind}: card and CPU probabilities differ by {out[kind]['max_abs_diff']}")
    check(out["ap_sim_vs_int_differing"] == 0, "ap_sim's codes differ from int's")
    return out


def variant_serve(model, params, reqs, opts, kind):
    """One variant served at full width (``opts`` with ``softmax_kind``
    ``kind``): decode steps CUDA-graph replays; its first
    VARIANT_OP_REQUESTS requests graphed == op by op bitwise (tokens, logit
    rows, pool bytes); greedy tokens equal a per-request eager generate of
    a model built with the variant (the first VARIANT_EAGER_REQUESTS) but
    at near ties; every
    served logit within phase 6's limits of a teacher-forced pass of the
    variant model; ``kernel="pallas"`` raises; ms per step of a warm
    graphed serve."""
    import dataclasses

    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    label = f"olmo-1b serve, softmax_kind {kind}"
    vopts = dataclasses.replace(opts, softmax_kind=kind)
    vm = Model(model.cfg.with_softmax(SoftmaxSpec(kind)))
    max_new = max(r.max_new for r in reqs)
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=max_new, sampler=rec)
    rep, _, rows, first_s, _ = counted_serve(eng, reqs, vopts, rec)
    check(rep.softmax_kind == kind and rep.step_replays > 0 and rep.op_by_op is None,
          f"{label}: {rep.step_replays} replays ({rep.op_by_op})")
    check(rep.leaked_blocks == 0 and cost_shares_sum(rep) and rep.cost.cycles > 0
          and rep.cost.backend == kind, f"{label}: pool or meter: {rep.cost.describe()}")
    sub = reqs[:VARIANT_OP_REQUESTS]
    rec_g, rec_o = _LogitRecorder(), _LogitRecorder()
    eng_g = Engine(model, params, max_new=max_new, sampler=rec_g)
    eng_o = op_by_op(Engine(model, params, max_new=max_new, sampler=rec_o))
    rep_g, _, rows_g, _, _ = counted_serve(eng_g, sub, vopts, rec_g)
    rep_o, _, rows_o, _, _ = counted_serve(eng_o, sub, vopts, rec_o)
    check(rep_o.step_replays == 0 and rep_o.op_by_op is not None,
          f"{label}: the op-by-op serve replayed")
    graph_vs_op = serve_graph_vs_op(f"{label}, first {len(sub)} requests", sub,
                                    (rep_g, rows_g, eng_g), (rep_o, rows_o, eng_o))
    del eng_g, eng_o, rows_g, rows_o
    ties = []
    veng = Engine(vm, params, max_new=max_new)
    for r, res in list(zip(reqs, rep.results))[:VARIANT_EAGER_REQUESTS]:
        ref = veng.generate(r.prompt[None], generator=torch.Generator("cuda").manual_seed(r.seed),
                            mode="eager", max_new=r.max_new, cache_len=rep.cache_len)
        compare_tokens(f"{label} vs eager, request {r.rid}", res.tokens, ref.tokens[0],
                       r.prompt_len, vm, params, ties)
    tf = teacher_forced(label, vm, params, reqs, [res.tokens for res in rep.results], rows,
                        VARIANT_LOGIT_TOL, VARIANT_LOGIT_RMS_TOL)
    check(max(tf["first_step_max"], tf["decode_max"]) <= VARIANT_LOGIT_TOL and
          tf["rms"] <= VARIANT_LOGIT_RMS_TOL, f"{label}: served logits differ from the "
          f"teacher-forced pass beyond the limits: {tf}")
    try:
        eng.serve(sub, dataclasses.replace(vopts, kernel="pallas"))
        rejected = None
    except ValueError as e:
        rejected = str(e)
    check(rejected is not None and "not an Alg.-1 dataflow" in rejected,
          f"{label}: kernel='pallas' did not reject the variant ({rejected})")
    del eng
    # warm graphed serves (the first captures), timed on the host clock
    eng_t = Engine(model, params, max_new=max_new)
    plain = dataclasses.replace(vopts, report_cost=False)
    eng_t.serve(reqs, plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep_t = eng_t.serve(reqs, plain)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = wall * 1e3 / rep_t.steps
    print(f"{label}: {rep.steps} decode steps, {rep.step_replays} replays; graph == op by "
          f"op on {len(sub)} requests; {VARIANT_EAGER_REQUESTS} eager generate(s), {len(ties)} "
          f"near-tie divergence(s); pallas rejects it; {rep.cost.describe()}; warm graphed serve "
          f"{wall * 1e3:.1f} ms, {ms:.3f} ms per step (prefills included), "
          f"{sum(r.max_new for r in reqs) / wall:.1f} generated tok/s; first serve "
          f"{first_s:.2f} s ({card_line()})", flush=True)
    return {"steps": rep.steps, "replays": rep.step_replays, "cost": dataclasses.asdict(rep.cost),
            "graph_vs_op_by_op": graph_vs_op, "ties": ties, "teacher_forced": tf,
            "pallas_rejects": rejected, "ms_per_step": ms, "wall_ms": wall * 1e3,
            "rows": rows}


def ap_sim_serve(model, params, opts):
    """ap_sim (the functional AP simulator) served at full width: AP_REQUESTS
    requests of AP_PROMPT tokens, AP_NEW new tokens each, through an engine
    whose steps would be graphed: the backend declares itself not
    capturable, so the serve runs op by op (0 replays, the reason in the
    report) and equals the ``int`` serve of the same requests run op by op
    bitwise (tokens, every logit row), with the same AP meter."""
    import dataclasses

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, model.cfg.vocab, AP_PROMPT).astype(np.int32),
                    max_new=AP_NEW, arrival=float(i), seed=100 + i) for i in range(AP_REQUESTS)]
    aopts = dataclasses.replace(opts, slots=AP_REQUESTS, softmax_kind="ap_sim")
    rec_a, rec_i = _LogitRecorder(), _LogitRecorder()
    t0 = time.perf_counter()
    rep_a, _, rows_a, _, _ = counted_serve(Engine(model, params, max_new=AP_NEW, sampler=rec_a),
                                           reqs, aopts, rec_a)
    wall = time.perf_counter() - t0
    rep_i, _, rows_i, _, _ = counted_serve(
        op_by_op(Engine(model, params, max_new=AP_NEW, sampler=rec_i)), reqs,
        dataclasses.replace(aopts, softmax_kind="int"), rec_i)
    same = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                          for a, b in zip(rep_a.results, rep_i.results)),
            "logit_rows": rows_equal(rows_a, rows_i) == len(reqs),
            "meter": all(getattr(rep_a.cost, f) == getattr(rep_i.cost, f)
                         for f in ("vectors", "cycles", "latency_s", "energy_j")),
            "op_by_op": rep_a.step_replays == 0 and "ap_sim" in (rep_a.op_by_op or "")}
    print(f"olmo-1b serve, softmax_kind ap_sim: {len(reqs)} requests x {AP_PROMPT} prompt "
          f"tokens, {AP_NEW} new, {rep_a.steps} steps in {wall:.2f} s, {rep_a.step_replays} "
          f"replays ({rep_a.op_by_op}); == the int serve op by op, bitwise: {same}; "
          f"{rep_a.cost.describe()}", flush=True)
    check(all(same.values()), f"ap_sim serve: {same}")
    return {**same, "steps": rep_a.steps, "wall_s": wall, "op_by_op_reason": rep_a.op_by_op}


def learnable_consmax_serve(cfg, tree, reqs, opts, default_rows):
    """A ConSmax model with learned (here: seeded, non-default) per-head
    beta and gamma, its parameters converted from the reference layout with
    their ``smx`` leaves, served once at full width: every request
    completes, its decode steps replay, and its logits differ from the
    default operating point's (``default_rows``: the softmax_kind consmax
    serve of the same model), so the learned values reach the softmax."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    lcfg = cfg.with_softmax(SoftmaxSpec("consmax"))
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, cfg.n_heads)
    smx = {"beta": rng.uniform(-1.5, 0.5, shape).astype(np.float32),
           "gamma": rng.uniform(0.5, 1.5, shape).astype(np.float32)}
    layers = tree["stack"]["layers"]
    ltree = {**tree, "stack": {**tree["stack"], "layers": {
        **layers, "attn": {**layers["attn"], "smx": smx}}}}
    lparams = params_from_numpy(ltree, lcfg, "cuda")
    got = lparams["stack"]["layers"]["attn"]["smx"]
    carried = all(got[k].dtype == torch.float32 and
                  np.array_equal(got[k].cpu().numpy(), smx[k]) for k in smx)
    rec = _LogitRecorder()
    rep, _, rows, _, _ = counted_serve(Engine(Model(lcfg), lparams, max_new=64, sampler=rec),
                                       reqs, opts, rec)
    finite = all(bool(torch.isfinite(x).all()) for rs in rows.values() for x in rs)
    moved = any(not torch.equal(rows[r.seed][0], default_rows[r.seed][0]) for r in reqs)
    out = {"smx_carried_f32": carried, "completed": len(rep.results) == len(reqs),
           "replays": rep.step_replays, "finite": finite, "differs_from_default": moved}
    print(f"olmo-1b with learnable ConSmax (seeded beta in [-1.5, 0.5], gamma in [0.5, 1.5] "
          f"per head and layer, converted with its smx leaves), {len(reqs)} request(s): {out}; "
          f"{rep.cost.describe()}", flush=True)
    check(carried and out["completed"] and rep.step_replays > 0 and finite and moved,
          f"learnable ConSmax serve: {out}")
    del lparams
    return out


def phase15_variants():
    """The softmax-variant zoo and ap_sim at olmo-1b's full width (phase
    15): the variants and ap_sim on one prefill layer's scores, card
    against CPU; each variant served (``variant_serve``), their AP meters
    ordered mive < sole < consmax < int; ap_sim's serve against int's;
    a learnable ConSmax model served."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    t_phase = time.perf_counter()
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int"), n_layers=OLMO_CUT_LAYERS)
    model = Model(cfg)
    tree = _tree_np(model.init(torch.Generator("cuda").manual_seed(0)))
    params = params_from_numpy(tree, cfg, "cuda")
    reqs = shared_prefix_trace(32, cfg.vocab, **SERVE_TRACE)[:VARIANT_REQUESTS]
    opts = ServeOptions(**{**SERVE_OPTIONS, "kernel": "jnp"})
    print(f"softmax variants: {cfg.name} full width, {cfg.n_layers} of its 16 layers, bf16 "
          f"seeded weights through "
          f"convert.params_from_numpy, softmax int; phase 6's trace cut to {len(reqs)} "
          f"requests, phase 6's options with kernel jnp ({card_line()})", flush=True)
    out = {"card_vs_cpu": variants_card_vs_cpu(model, params)}
    rec = _LogitRecorder()
    rep_int = counted_serve(Engine(model, params, max_new=64, sampler=rec), reqs, opts, rec)[0]
    out["int_cycles"] = rep_int.cost.cycles
    rows = {}
    for kind in VARIANTS:
        out[kind] = variant_serve(model, params, reqs, opts, kind)
        rows[kind] = out[kind].pop("rows")
    cycles = [out[k]["cost"]["cycles"] for k in ("mive", "sole", "consmax")] + [rep_int.cost.cycles]
    print(f"  AP meter cycles of the serve: mive {cycles[0]} < sole {cycles[1]} < consmax "
          f"{cycles[2]} < int {cycles[3]}: {cycles == sorted(set(cycles))}", flush=True)
    check(all(c > 0 for c in cycles) and cycles == sorted(set(cycles)),
          f"the variants' AP cycles are not ordered mive < sole < consmax < int: {cycles}")
    out["ap_sim"] = ap_sim_serve(model, params, opts)
    out["learnable_consmax"] = learnable_consmax_serve(cfg, tree, reqs[:VARIANT_EAGER_REQUESTS],
                                                       opts, rows["consmax"])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 15 in {out['seconds']:.1f} s ({card_line()})", flush=True)
    return out


# ----------------------------------------------------------------- phase 16

# The MoE family (ROADMAP.md item 11) at full width, its depth cut to
# MOE_LAYERS layers: all 40 of dbrx-132b's layers are about 264 GB of bf16
# weights and all 60 of deepseek-v2-236b's about 472 GB (item 14). Four
# layers: dbrx 28.5 GB, deepseek-v2 26.6 GB (its dense prefix layer and 3
# MoE layers).
MOE_LAYERS = 4
MOE_REQUESTS = 8
# Model.init draws the embedding at std 0.02, as the reference's init does.
# With random weights the attention output, alike for every token of a
# sequence, then swamps the embedding and the tokens of a sequence route to
# the same experts: the reference's capacity drops a quarter to a third of
# a prompt's assignments ((d) prints the share). The phase's models draw
# the embedding at std MOE_EMBED_STD, where the tokens of a sequence route
# apart and the prefills drop no assignment ((d) compares both inputs).
MOE_EMBED_STD = 1.0
# The MoE serves against their teacher-forced passes (``moe_forced_rows``).
# Phase 6's floor, a serve without the fused kernel against the forced
# pass, is 0 here: the jnp serve equals its forced pass bitwise on the H100
# (the prefills are the same calls, and every dense product of an MoE step
# pads to 64 rows, so a step of 8 slots and one of 8 forced rows run the
# same shapes). What is left is K2's (K4's) rounding, within its
# per-element bounds (phases 5, 7), carried through the router: where a
# token's k-th and (k+1)-th probabilities are near, a last-ulp change
# picks another expert and moves that token's FFN output by O(1), which
# reads as a few large logit differences beside a small RMS. The limits
# are 1.3 times the plain serve's reading on the H100 (phase 16; equal in
# every call), and each lies between two readings: the sound runs' largest
# (max, RMS: dbrx-132b 0.877, 0.0297, the RMS of the spec serve's request
# a verify round's drop reached; deepseek-v2-236b 0.625, 0.02888) and the
# control's, the serve with the fused kernel leaving out each sequence's
# first page (``_first_page_left_out``; dbrx-132b 1.461, 0.08368,
# deepseek-v2-236b 0.9219, 0.07225), which phase 16 requires to fail.
MOE_LOGIT_TOL = {"dbrx-132b": 1.3 * 0.877, "deepseek-v2-236b": 1.3 * 0.625}
MOE_LOGIT_RMS_TOL = {"dbrx-132b": 1.3 * 0.02631, "deepseek-v2-236b": 1.3 * 0.02888}
# (d): the MoE layer on the card against the port's CPU path, both bf16, on
# the same input and weights: experts compared wherever the CPU router's
# top-k margin exceeds MOE_MARGIN (an f32 CPU path would not do: the bf16
# router product alone moves a probability by ~2e-3); the output over the
# tokens routed alike within MOE_LAYER_RMS_TOL of the CPU output's RMS,
# five bf16 roundings (2^-8 each): the two sides round the same products
# summed in other orders.
MOE_MARGIN = 1e-3
MOE_LAYER_RMS_TOL = 5 * 2.0 ** -8


def moe_model(arch):
    """Full-width ``arch`` at MOE_LAYERS layers, softmax int_pallas, seeded
    random bf16 weights on the card, the embedding at MOE_EMBED_STD."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model

    cfg = get_config(arch, softmax=SoftmaxSpec("int_pallas"), n_layers=MOE_LAYERS)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    params["embed"]["w"].mul_(MOE_EMBED_STD / 0.02)
    return model, params


class RouteDrops:
    """While active, counts the assignments each MoE routing call drops
    (``moe._route``'s targets at the sentinel row E * C), all of them, and,
    inside ``eng``'s serve steps of more than one token a row (the verify
    rounds), by request seed of each slot's generator: the assignments
    dropped, and the rounds whose drop reaches an emitted row. Slots go in
    token order, so a block drops its later tokens' assignments; a row of
    the block sees the tokens up to it (their routing, then their K/V in
    the next layer), so the round's emitted rows (the first n_emit) keep
    the decode step's bits unless a token among them dropped one. ``eng``
    must run op by op: a graph replay calls no Python."""

    def __init__(self, eng=None):
        self.eng, self.total, self.generators = eng, 0, None
        self.verify_by_seed, self.reaching_by_seed = {}, {}

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe._route

        def counted(p, x, cfg, ctx):
            out = self.route(p, x, cfg, ctx)
            if x.device.type != "meta":
                dropped = out[1] == cfg.n_experts * out[0]          # [B, S * k]
                self.total += int(dropped.sum())
                if self.generators is not None and x.shape[1] > 1:
                    k = cfg.moe_top_k
                    pos = torch.arange(dropped.shape[1], device=x.device) // k
                    first = torch.where(dropped, pos, dropped.shape[1]).min(-1).values
                    self.first = torch.minimum(self.first, first.cpu())
                    for g, n in zip(self.generators, dropped.sum(-1).tolist()):
                        if g is not None and n:
                            s = g.initial_seed()
                            self.verify_by_seed[s] = self.verify_by_seed.get(s, 0) + n
            return out

        moe._route = counted
        if self.eng is not None:
            self.orig = self.eng._serve_decode

            def serve_decode(st, host_inputs, generators):
                self.generators = generators
                self.first = torch.full((len(generators),), 1 << 30)
                try:
                    packed, logits = self.orig(st, host_inputs, generators)
                finally:
                    self.generators = None
                for g, f, n_emit in zip(generators, self.first.tolist(), packed[:, -1]):
                    if g is not None and f < int(n_emit):
                        s = g.initial_seed()
                        self.reaching_by_seed[s] = self.reaching_by_seed.get(s, 0) + 1
                return packed, logits

            self.eng._serve_decode = serve_decode
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route
        if self.eng is not None:
            self.eng._serve_decode = self.orig


def moe_forced_rows(model, params, reqs, results, cache_len):
    """Teacher-forced logits of a serve's tokens that route as the serve
    did. One causal pass over the served tokens (phase 6's teacher-forced
    pass) would route each sequence as one group, whose capacity differs
    from the serve's prefill's and decode steps', and so drop other
    assignments: the reference's semantics, not a rounding. Here each
    request's prompt is prefilled as the serve prefilled it (whole, or as a
    tail over the shared prefix of the request that registered it, whose
    whole prefill is rerun), and the served tokens are fed back through
    decode steps of all the requests at once (contiguous cache, the gather
    decode and K1, op by op). Returns the rows by request seed: the
    prefill's last logits, then each step's."""
    from repro_torch.models import kv_cache

    by_rid = {r.rid: r for r in reqs}
    whole = [res for res in results if res.shared_prefix == 0]
    first = min(res.admitted_at for res in whole)
    owners = [res for res in whole if res.admitted_at == first]
    check(len(owners) == 1, f"{len(owners)} requests prefilled first, whole")
    owner = by_rid[owners[0].rid]
    dev = model.device
    tok = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=torch.long, device=dev)
    rows, caches = {}, []
    owner_cache = None
    for res in results:
        r, s = by_rid[res.rid], res.shared_prefix
        if s == 0:
            logits, c = model.prefill(params, {"tokens": tok(r.prompt)}, cache_len=cache_len)
        else:
            check(np.array_equal(r.prompt[:s], owner.prompt[:s]),
                  f"request {r.rid}: its shared prefix is not request {owner.rid}'s")
            if owner_cache is None:
                owner_cache = model.prefill(params, {"tokens": tok(owner.prompt)},
                                            cache_len=cache_len)[1]
            prefix = {k: v[:, :, :s] for k, v in owner_cache.items()}
            logits, tail = model.prefill_tail(params, {"tokens": tok(r.prompt[s:])}, prefix, s)
            c = {k: torch.zeros_like(v) for k, v in owner_cache.items()}
            for k in c:
                c[k][:, :, :s] = prefix[k]
                c[k][:, :, s:r.prompt_len] = tail[k]
        rows[r.seed] = [logits[0, -1].float()]
        caches.append(c)
    cache = {k: torch.cat([c[k] for c in caches], dim=1) for k in caches[0]}
    steps = max(r.max_new for r in reqs) - 1
    plen = np.array([by_rid[res.rid].prompt_len for res in results])
    nnew = np.array([by_rid[res.rid].max_new for res in results])
    width = max(len(res.tokens) for res in results) + steps
    toks = np.stack([np.pad(res.tokens, (0, width - len(res.tokens))) for res in results])
    for t in range(steps):
        live = t < nnew - 1
        pos = np.where(live, plen + t, cache_len)           # a parked row writes nothing
        step_tok = torch.as_tensor(toks[np.arange(len(results)), plen + t][:, None],
                                   dtype=torch.long, device=dev)
        logits, cache = model.decode_step(params, cache, {"token": step_tok},
                                          torch.as_tensor(pos, dtype=torch.int32, device=dev))
        for i, res in enumerate(results):
            if live[i]:
                rows[by_rid[res.rid].seed].append(logits[i, -1].float())
    return rows


def moe_forced_checks(label, reqs, results, rows, forced, tol, rms_tol, gate=True):
    """A serve's rows against its forced pass (``moe_forced_rows``): the
    first row of each request (its prefill's, the same function on the same
    inputs) bitwise equal; each served token the argmax of its forced row,
    or that row's top-2 margin below NEAR_TIE_ULPS bf16 ulps of its top
    logit; every served logit within ``tol`` of the forced one and the RMS
    within ``rms_tol``. Returns the statistics with the checks that fail
    (``caught_by``); with ``gate`` a failing check fails the phase."""
    by_rid = {r.rid: r for r in reqs}
    top = sq = 0.0
    n = first_equal = 0
    ties, beyond, tops = [], [], []
    for res in results:
        r = by_rid[res.rid]
        got, want = torch.stack(rows[r.seed]), torch.stack(forced[r.seed])
        check(len(got) == len(want) == r.max_new, f"{label}, request {r.rid}: rows "
              f"{len(got)} / {len(want)} for {r.max_new} tokens")
        first_equal += bool(torch.equal(got[0].float(), want[0]))
        d = (got.float() - want).abs()
        top = max(top, float(d.max()))
        sq += float(d.double().pow(2).sum())
        n += d.numel()
        served = torch.as_tensor(res.tokens[r.prompt_len:], device=want.device)
        best = want.topk(2, dim=-1)
        tops.append(best.values[:, 0].abs().cpu())
        off = torch.nonzero(best.indices[:, 0] != served).flatten().tolist()
        for t in off:
            t1, t2 = float(best.values[t, 0]), float(best.values[t, 1])
            bound = NEAR_TIE_ULPS * 2.0 ** (float(np.floor(np.log2(abs(t1)))) - 7)
            (ties if t1 - t2 < bound else beyond).append(
                {"request": r.rid, "step": t, "margin": t1 - t2, "top": t1,
                 "near_tie_bound": bound})
    tops = torch.cat(tops)
    rms = (sq / n) ** 0.5
    caught = {"first_rows": first_equal < len(results), "tokens": bool(beyond),
              "logit_max": top > tol, "logit_rms": rms > rms_tol}
    stats = {"run": label, "requests": len(results), "max": top, "rms": rms,
             "first_rows_bitwise": first_equal, "near_ties": ties,
             "tokens_beyond_near_tie": beyond,
             "top_logit_p50": float(tops.median()), "top_logit_max": float(tops.max()),
             "caught_by": [k for k, v in caught.items() if v]}
    print(f"  forced pass, {label}: {len(results)} requests, first rows bitwise equal "
          f"{first_equal}, served tokens == the forced argmax but at {len(ties)} near tie(s) "
          f"(margins {sorted(round(t['margin'], 4) for t in ties)[-5:]} at most) and "
          f"{len(beyond)} beyond; logits max |diff| {top:.4g}, RMS {rms:.4g} (limits {tol}, "
          f"RMS {rms_tol}); top logits |p50| {stats['top_logit_p50']:.4g}, max "
          f"{stats['top_logit_max']:.4g}; failing checks: {stats['caught_by'] or 'none'}",
          flush=True)
    check(not gate or not stats["caught_by"], f"{label}: fails {stats['caught_by']}: {stats}")
    return stats


def _first_page_left_out(attend, at):
    """``attend`` (K2's or K4's model-layout wrapper: its block table is
    argument ``at``, the positions the next, the pool the one two before)
    with each sequence's first page left out of its keys: the table
    shifted one page left and the positions one page back, so each query
    sees its keys but the first BS. The control of phase 16's serves."""
    def left_out(*args, **kw):
        args = list(args)
        table, positions = args[at], args[at + 1]
        bs = args[at - 2].shape[1]
        args[at] = torch.cat([table[:, 1:], table[:, -1:]], dim=1)
        args[at + 1] = (positions - bs).clamp(min=0)
        return attend(*args, **kw)
    return left_out


# the fused kernel -> its wrapper in kernels/paged_attention/ops.py and the
# argument that is its block table
MOE_CONTROL = {"K2": ("paged_attend_dense", 3), "K4": ("paged_attend_mla", 4)}


def moe_generate(model, params):
    """(a) ``Engine.generate(mode="fused")`` at batch 4, prompt 512, 32 new
    tokens (``graphed_generate``: K1 n_layers x 32, graph == op by op and
    == eager bitwise), then the plain Alg. 1 (``int``) bitwise equal."""
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    cfg = model.cfg
    batch, prompt_len, max_new = 4, 512, 32
    prompts = SyntheticCorpus(cfg.vocab, seed=1234).sample(batch, prompt_len,
                                                           seed=777)[:, :prompt_len]
    rec, res = graphed_generate(f"{cfg.name} generate", model, params, prompts, max_new,
                                rounds=1, eager_mode=False)
    res_int = Engine(Model(cfg.with_softmax(SoftmaxSpec("int"))), params,
                     max_new=max_new).generate(prompts, mode="fused")
    same = (np.array_equal(res_int.tokens, res.tokens)
            and torch.equal(res_int.logits, res.logits))
    bound = rl.weight_read_bound_ms(params, rl.hbm_rate(torch.cuda.get_device_name(0)))
    print(f"  {cfg.name} generate: int_pallas vs int (plain Alg. 1) on the card, tokens and "
          f"last logits bitwise equal: {same}; {rec['ms_per_step']['graph']:.3f} ms per "
          f"decode step graphed ({rec['ms_per_step']['op by op']:.3f} op by op) against a "
          f"weight-read bound of {bound:.3f} ms (every weight but the embedding at the "
          f"card's HBM rate); peak {rec['peak_gib']:.2f} GiB ({card_line()})", flush=True)
    check(same, f"{cfg.name}: int and int_pallas generate differ")
    rec["weight_read_bound_ms"] = bound
    rec.pop("walls_s")
    return rec


def moe_serve(model, params, reqs, fused, group):
    """(b) / (c): the plain serve of ``reqs`` with phase 6's options,
    graphed: the fused kernel ``fused`` ("K2" / "K4") n_layers x steps,
    every call at (T 1, ``group`` rows), K1 n_layers x requests, nothing
    else; graph == op by op bitwise on 1 request; the forced-pass checks
    (``moe_forced_checks``) of the pallas serve, and of the jnp serve as the
    floor; a control serve, ``fused`` leaving out each sequence's first
    page (``_first_page_left_out``), failing them; a warm graphed serve's
    ms per step beside the weight-read bound. Returns (record, report,
    rows); the record's ``"routes"``: the op-by-op first request's routing
    calls (``RouteIds``)."""
    import dataclasses

    from repro_torch.launch import roofline as rl
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    cfg, arch = model.cfg, model.cfg.name
    opts = ServeOptions(**SERVE_OPTIONS)
    max_new = max(r.max_new for r in reqs)
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=max_new, sampler=rec)
    torch.cuda.reset_peak_memory_stats()
    with KernelWidths() as widths:
        rep, counted, rows, first_s, replayed = counted_serve(eng, reqs, opts, rec)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(rep.results) == len(reqs) and rep.leaked_blocks == 0
          and rep.shared_prefill_tokens > 0 and cost_shares_sum(rep),
          f"{arch} serve: results {len(rep.results)}, leaked {rep.leaked_blocks}, shared "
          f"{rep.shared_prefill_tokens}, cost shares {cost_shares_sum(rep)}")
    per_replay = {k: 0 for k in counted}
    per_replay[fused] = cfg.n_layers
    traces = replay_trace(f"{arch} serve", replayed_graphs(eng, replayed))
    n = path_launches(f"{arch} serve", counted, replayed, traces, per_replay)
    want = {k: 0 for k in n}
    want.update({"K1": cfg.n_layers * len(reqs), fused: cfg.n_layers * rep.steps})
    w = widths.widths(fused)
    print(f"{arch} serve: {len(reqs)} requests, {rep.steps} decode steps, prefill "
          f"{rep.prefill_tokens} tokens + shared {rep.shared_prefill_tokens}; launches {n} "
          f"(expected {want}); {fused} calls at (T, rows) {w} (expected [(1, {group})]); "
          f"first serve {first_s:.2f} s, peak {peak:.2f} GiB", flush=True)
    check(n == want, f"{arch} serve: kernel launches {n} != {want}")
    check(w == [(1, group)], f"{arch} serve: {fused} ran at (T, rows) {w}")
    # graph == op by op on the first SERVE_OP_SUBSET requests
    sub = reqs[:SERVE_OP_SUBSET]
    runs = []
    for graphed in (True, False):
        r2 = _LogitRecorder()
        e2 = Engine(model, params, max_new=max_new, sampler=r2)
        if not graphed:
            op_by_op(e2)
        with RouteIds(not graphed) as ids:
            runs.append((counted_serve(e2, sub, opts, r2)[0], r2.rows, e2))
    routes = {"calls": ids.calls, "tokens": runs[1][0].results[0].tokens,
              "prompt_len": sub[0].prompt_len}
    graph_vs_op = serve_graph_vs_op(f"{arch} serve, first {len(sub)} request(s)", sub, *runs)
    del runs
    tol, rms_tol = MOE_LOGIT_TOL[arch], MOE_LOGIT_RMS_TOL[arch]
    forced = moe_forced_rows(model, params, reqs, rep.results, rep.cache_len)
    pallas = moe_forced_checks(f"{arch} serve kernel=pallas", reqs, rep.results, rows, forced,
                               tol, rms_tol)
    rec.rows = {}
    rep_j = eng.serve(reqs, dataclasses.replace(opts, kernel="jnp", report_cost=False))
    rows_j, rec.rows = rec.rows, {}
    forced_j = moe_forced_rows(model, params, reqs, rep_j.results, rep_j.cache_len)
    floor = moe_forced_checks(f"{arch} serve kernel=jnp (the floor)", reqs, rep_j.results,
                              rows_j, forced_j, tol, rms_tol)
    del forced, forced_j, rows_j
    # the control: the same serve, graphed, with the first page of every
    # sequence left out of the fused kernel's keys; the checks must fail it
    from repro_torch.kernels.paged_attention import ops as paged_ops

    attr, at = MOE_CONTROL[fused]
    sound = getattr(paged_ops, attr)
    setattr(paged_ops, attr, _first_page_left_out(sound, at))
    rec.rows = {}
    try:
        # a fresh engine: its step graph is captured with the fault
        rep_c = Engine(model, params, max_new=max_new, sampler=rec).serve(
            reqs, dataclasses.replace(opts, report_cost=False))
    finally:
        setattr(paged_ops, attr, sound)
    rows_c, rec.rows = rec.rows, {}
    forced_c = moe_forced_rows(model, params, reqs, rep_c.results, rep_c.cache_len)
    control = moe_forced_checks(f"{arch} serve kernel=pallas, control: {fused} leaves out "
                                f"each sequence's first page", reqs, rep_c.results, rows_c,
                                forced_c, tol, rms_tol, gate=False)
    check(control["caught_by"], f"{arch}: the control serve passes every forced-pass check")
    del forced_c, rows_c
    # a warm graphed serve with the registry's greedy sampler
    timed = Engine(model, params, max_new=max_new)
    timed.serve(reqs, dataclasses.replace(opts, report_cost=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = timed.serve(reqs, dataclasses.replace(opts, report_cost=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bound = rl.weight_read_bound_ms(params, rl.hbm_rate(torch.cuda.get_device_name(0)))
    (trace,) = traces.values()
    print(f"  {arch} serve, warm graphed: {wall * 1e3 / warm.steps:.3f} ms per step "
          f"({warm.steps} steps, prefills included; one replayed step's device span "
          f"{trace['span_ms']:.3f} ms) against a weight-read bound of {bound:.3f} ms a step "
          f"({card_line()})", flush=True)
    out = {"arch": arch, "layers": cfg.n_layers, "requests": len(reqs), "steps": rep.steps,
           "launches": n, "kernel_widths": w, "graph_vs_op_by_op": graph_vs_op,
           "forced_pallas": pallas, "forced_jnp_floor": floor, "forced_control": control,
           "peak_gib": peak,
           "ms_per_step": wall * 1e3 / warm.steps, "weight_read_bound_ms": bound,
           "step_trace": trace, "routes": routes}
    return out, rep, rows


def moe_spec(model, params, reqs, plain, plain_rows):
    """(b)'s speculative serve (n-gram drafts of SPEC_K, K2 at T 5): op by op
    with every verify round's dropped assignments counted by request, then
    graphed: graph == op by op bitwise (tokens, every row, pool bytes); K2
    n_layers x rounds all at (5, 5 x group), K1 n_layers x requests; every
    request no verify round's drop reached (``RouteDrops``) bitwise equal to
    the plain serve (tokens and every row); the others listed and held to
    the forced-pass limits."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    cfg, arch = model.cfg, model.cfg.name
    group = cfg.n_heads // cfg.n_kv_heads
    opts = ServeOptions(**{**SERVE_OPTIONS, "report_cost": False}, speculative=True,
                        draft="ngram", draft_k=SPEC_K)
    max_new = max(r.max_new for r in reqs)
    eng_o = op_by_op(Engine(model, params, max_new=max_new))
    rec_o = SpecRecorder(eng_o)
    with RouteDrops(eng_o) as drops:
        rep_o = counted_serve(eng_o, reqs, opts, rec_o)[0]
    rows_o = rec_o.trimmed(reqs)
    rec_o.detach()
    eng_g = Engine(model, params, max_new=max_new)
    rec_g = SpecRecorder(eng_g)
    with KernelWidths() as widths:
        rep_g, counted, _, first_s, replayed = counted_serve(eng_g, reqs, opts, rec_g)
    rows_g = rec_g.trimmed(reqs)
    rec_g.detach()
    graph_vs_op = serve_graph_vs_op(f"{arch} spec serve", reqs, (rep_g, rows_g, eng_g),
                                    (rep_o, rows_o, eng_o))
    per_replay = {k: 0 for k in counted}
    per_replay["K2"] = cfg.n_layers
    traces = replay_trace(f"{arch} spec serve", replayed_graphs(eng_g, replayed))
    n = path_launches(f"{arch} spec serve", counted, replayed, traces, per_replay)
    want = {k: 0 for k in n}
    want.update({"K1": cfg.n_layers * len(reqs), "K2": cfg.n_layers * rep_g.steps})
    t = SPEC_K + 1
    w = widths.widths("K2")
    dropped = {r.rid: drops.verify_by_seed[r.seed] for r in reqs if r.seed in drops.verify_by_seed}
    reaching = {r.rid: drops.reaching_by_seed[r.seed] for r in reqs
                if r.seed in drops.reaching_by_seed}
    print(f"{arch} spec serve: {rep_g.steps} rounds against the plain serve's {plain.steps} "
          f"steps, drafted {rep_g.drafted_tokens}, accepted {rep_g.accepted_tokens}, "
          f"acceptance rate {rep_g.acceptance_rate:.4f}; launches {n} (expected {want}); K2 "
          f"calls at (T, rows) {w} (expected [({t}, {t * group})]); verify rounds dropped "
          f"{sum(dropped.values())} assignments (by request {dropped}), rounds whose drop "
          f"reached an emitted row by request {reaching}; first serve {first_s:.2f} s",
          flush=True)
    check(n == want, f"{arch} spec serve: kernel launches {n} != {want}")
    check(w == [(t, t * group)], f"{arch} spec serve: K2 ran at (T, rows) {w}")
    base = plain.by_rid()
    clean = [r for r in reqs if r.rid not in reaching]
    same = {r.rid: bool(np.array_equal(rep_g.by_rid()[r.rid].tokens, base[r.rid].tokens)
                        and rows_equal({r.seed: rows_g[r.seed]},
                                       {r.seed: plain_rows[r.seed]}) == 1)
            for r in clean}
    print(f"  {arch} spec serve: requests no verify round's drop reached "
          f"({len(clean)} of {len(reqs)}) bitwise equal to the plain serve (tokens, every "
          f"logit row): {same}", flush=True)
    check(all(same.values()), f"{arch} spec serve differs from the plain serve on drop-free "
          f"requests: {same}")
    out = {"rounds": rep_g.steps, "plain_steps": plain.steps,
           "acceptance_rate": rep_g.acceptance_rate, "launches": n, "kernel_widths": w,
           "verify_drops_by_request": dropped, "rounds_drop_reached_by_request": reaching,
           "clean_equal_plain": same,
           "graph_vs_op_by_op": graph_vs_op, "step_trace": next(iter(traces.values()))}
    if reaching:
        sub = [r for r in reqs if r.rid in reaching]
        res = [rep_g.by_rid()[r.rid] for r in sub]
        forced = moe_forced_rows(model, params, reqs, rep_g.results, rep_g.cache_len)
        out["dropped_forced"] = moe_forced_checks(
            f"{arch} spec serve, requests a verify round's drop reached", sub, res, rows_g,
            forced, MOE_LOGIT_TOL[arch], MOE_LOGIT_RMS_TOL[arch])
    return out


def moe_layer_input(model, params, std):
    """The input of the first MoE layer's FFN on a 512-token prompt (its
    norm2 output after the layer's attention) at embedding std ``std``,
    [1, 512, d] bf16 on the card: (d)'s and (g)'s input."""
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.layers import norm_apply, positions_for
    from repro_torch.models.transformer import layer_params

    cfg, ctx = model.cfg, model.prefill_ctx
    lp = layer_params(params["stack"]["layers"], 0)
    prompt = SyntheticCorpus(cfg.vocab, seed=1234).sample(1, 512, seed=778)[:, :512]
    tokens = torch.as_tensor(prompt, dtype=torch.long, device="cuda")
    pos = positions_for(tokens.shape, device="cuda")
    with torch.no_grad():
        x = params["embed"]["w"][tokens] * (std / MOE_EMBED_STD)
        h = norm_apply(lp["norm1"], x, cfg.norm, ctx)
        x = x + attn_apply(lp["attn"], h, cfg, ctx, pos)
        return norm_apply(lp["norm2"], x, cfg.norm, ctx)


def moe_layer_card_vs_cpu(model, params):
    """(d) One full-width MoE layer (dbrx-132b's first) on the card
    against the port's CPU path (bf16, the same weights) on the same bf16
    input: the layer's input on a 512-token prompt (its norm2 output after
    the layer's attention), at the phase's embedding (MOE_EMBED_STD; no
    assignment drops) and at Model.init's (std 0.02; a share drops). At
    each: expert ids equal wherever the CPU router's top-k margin exceeds
    MOE_MARGIN, each assignment's slot (or drop) equal wherever no token up
    to it routed an expert differently, and at std 0.02 dropped assignments
    among those compared (the card's drop path held against the CPU's);
    the output's RMS difference over the tokens routed alike within
    MOE_LAYER_RMS_TOL of the CPU output's RMS."""
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx
    from repro_torch.models.transformer import layer_params

    cfg = model.cfg
    k, e = cfg.moe_top_k, cfg.n_experts
    lp = layer_params(params["stack"]["layers"], 0)
    ctx = model.prefill_ctx
    ffn_cpu = _tree_to(lp["ffn"], "cpu")
    cpu_ctx = Ctx(dtype=torch.bfloat16)

    def compare(std):
        with torch.no_grad():
            h = moe_layer_input(model, params, std)
            y_card, aux_card = moe.moe_apply(lp["ffn"], h, cfg, ctx)
            c, t_card, _, _ = moe._route(lp["ffn"], h, cfg, ctx)
            probs_card = torch.softmax((h @ lp["ffn"]["router"]["w"]).float(), -1)
            ids_card = moe._top_k(probs_card, k)[1].cpu()[0]
            t0 = time.perf_counter()
            x_cpu = h.cpu()
            y_cpu, aux_cpu = moe.moe_apply(ffn_cpu, x_cpu, cfg, cpu_ctx)
            _, t_cpu, _, _ = moe._route(ffn_cpu, x_cpu, cfg, cpu_ctx)
            y_cpu = y_cpu.float()
            probs_cpu = torch.softmax((x_cpu @ ffn_cpu["router"]["w"]).float(), -1)
            cpu_s = time.perf_counter() - t0
        top = torch.sort(probs_cpu[0], -1, descending=True).values
        wide = top[:, k - 1] - top[:, k] > MOE_MARGIN
        ids_cpu = moe._top_k(probs_cpu, k)[1][0]
        ids_equal = bool(torch.equal(ids_card[wide], ids_cpu[wide]))
        member = lambda ids: torch.zeros((ids.shape[0], e), dtype=torch.bool).scatter_(1, ids, True)
        differs = torch.cumsum((member(ids_card) != member(ids_cpu)).int(), 0) > 0
        alike = (ids_card == ids_cpu) & ~differs.gather(1, ids_card)        # [512, k]
        tc, th = t_card.cpu()[0].reshape(-1, k), t_cpu[0].reshape(-1, k)
        slots_equal = bool(torch.equal(tc[alike], th[alike]))
        tok_alike = alike.all(-1)
        d = (y_card.float().cpu()[0] - y_cpu[0])[tok_alike]
        rms = float(d.pow(2).mean().sqrt()) / float(y_cpu[0][tok_alike].pow(2).mean().sqrt())
        out = {"embed_std": std, "tokens": 512, "capacity": c,
               "drop_share": float((t_cpu == e * c).float().mean()),
               "under_margin": int((~wide).sum()), "ids_equal_over_margin": ids_equal,
               "assignments_compared": int(alike.sum()),
               "drops_compared": int((th[alike] == e * c).sum()),
               "slots_equal": slots_equal, "tokens_routed_alike": int(tok_alike.sum()),
               "max_abs_diff": float(d.abs().max()), "rms_rel": rms,
               "aux_card": float(aux_card), "aux_cpu": float(aux_cpu), "cpu_s": cpu_s}
        print(f"  {cfg.name} MoE layer, card vs CPU (bf16) on 512 tokens, embedding std {std}: "
              f"C {c}; {out['drop_share']:.2%} of the assignments dropped; "
              f"{out['under_margin']} tokens under a top-{k} margin of {MOE_MARGIN}; expert ids "
              f"equal over it: {ids_equal}; slots and drops equal on the "
              f"{out['assignments_compared']} assignments routed alike up to them "
              f"({out['drops_compared']} dropped): {slots_equal}; output over the "
              f"{out['tokens_routed_alike']} tokens routed alike: max |diff| "
              f"{out['max_abs_diff']:.4g}, RMS {rms:.4g} of the CPU output's (limit "
              f"{MOE_LAYER_RMS_TOL}); aux {out['aux_card']:.6g} / {out['aux_cpu']:.6g}; CPU "
              f"{cpu_s:.1f} s", flush=True)
        check(ids_equal and slots_equal and rms <= MOE_LAYER_RMS_TOL,
              f"{cfg.name} MoE layer, embedding std {std}: card and CPU disagree: {out}")
        return out

    runs = [compare(MOE_EMBED_STD), compare(0.02)]
    check(runs[1]["drops_compared"] > 0, f"{cfg.name} MoE layer at embedding std 0.02: no "
          f"dropped assignment among those compared: {runs[1]}")
    return runs


# (e)-(g): expert parallelism (ROADMAP item 22). The MoE serves of (b) and
# (c) over shards on cuda:0 (tp_serve, phase 20's sharded serve), each held
# against phase 16's single-device serve of the same requests at tier (b):
# tokens equal but at near ties, the step-aligned logits within
# MOE_TP_TOL (max, RMS). dbrx-132b over 2 and 4 shards (its 16 experts in
# blocks of 8 and 4; each shard's K2 at 4 and 2 kv-heads, group 6),
# deepseek-v2-236b over 2 (80 experts a shard; K4 at 64 heads on the latent
# pool gathered along the rank). No sharded serve is bitwise on the H100
# (the attention's column slices and a shard's K2 carry other bits, as in
# phase 20), and a token near a routing tie then picks another expert: a few
# large differences beside a small RMS, as phase 16's forced-pass limits
# read; so a divergence at a routing near tie counts as a near tie too
# (``first_divergence``). The limits are 1.3 times the largest sound
# reading on the H100, the same in every run (PERF.md §6, PR 30):
# dbrx-132b max 1.033 at 2 shards, RMS 0.03991 at 4 (the a2a serve's
# 0.6211 / 0.02185 under them), deepseek-v2-236b 0.4766 / 0.02562 at 2.
# The faults of --fault-control read 3.504 / 0.616 (the experts' outputs
# gathered out of order) and 2.323 / 0.3937 (the last shard's experts
# giving zeros).
MOE_TP_SHARDS = {"dbrx-132b": (2, 4), "deepseek-v2-236b": (2,)}
MOE_TP_TOL = {"dbrx-132b": (1.3 * 1.033, 1.3 * 0.03991),
              "deepseek-v2-236b": (1.3 * 0.4766, 1.3 * 0.02562)}
# (g)'s a2a serves, single-device and sharded, on the first requests of the
# trace (both sides are (g)'s own)
MOE_A2A_REQUESTS = 4
# (g): the capacity factors of the a2a checks: at 16 no segment drops (a2a
# must give gather's outputs), at 1.0 a segment of 128 assignments takes 8
# a expert (C_seg) where gather's whole prompt takes 128, so the two drop
# other assignments
A2A_NO_DROP, A2A_DROPS = 16.0, 1.0


class RouteIds:
    """While ``on``, records the experts of every MoE routing call
    (``moe._top_k``'s ids, [B, S, k] on the host) in call order. Op by op
    only: a graph replay calls no Python."""

    def __init__(self, on=True):
        self.on, self.calls = on, []

    def __enter__(self):
        if self.on:
            from repro_torch.models import moe

            self.moe, self.top_k = moe, moe._top_k

            def top_k(probs, k):
                w, i = self.top_k(probs, k)
                if probs.device.type != "meta":          # not the AP meter's
                    self.calls.append(i.cpu())
                return w, i

            moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        if self.on:
            self.moe._top_k = self.top_k


def routes_differ(a, b, cfg) -> dict:
    """Two op-by-op serves of one request (``RouteIds`` calls beside its
    tokens), their routing compared call by call over the forwards whose
    inputs were the same: the prefill and the decode steps up to the first
    step whose token differs (that step's forward included). Returns the
    routed assignments (a token's expert in ``a``) that ``b``'s token did
    not route to, of those compared."""
    moe_layers = cfg.n_layers - cfg.n_dense_prefix
    ta, tb = np.asarray(a["tokens"]), np.asarray(b["tokens"])
    diff = np.nonzero(ta != tb)[0]
    forwards = (int(diff[0]) - a["prompt_len"] + 1) if diff.size else len(a["calls"])
    n = differ = 0
    calls = a["calls"][:forwards * moe_layers]
    for x, y in zip(calls, b["calls"]):
        member = lambda ids: torch.zeros(ids.shape[:-1] + (cfg.n_experts,),
                                         dtype=torch.bool).scatter_(-1, ids, True)
        differ += int((member(x) & ~member(y)).sum())
        n += x.numel()
    return {"forwards_compared": min(forwards, len(a["calls"]) // moe_layers),
            "token_divergence": None if not diff.size else int(diff[0]) - a["prompt_len"],
            "assignments": n, "differ": differ}


def moe_sharded(model, params, reqs, single, name):
    """(e) / (f): ``reqs`` over each of MOE_TP_SHARDS[arch] shards on cuda:0
    (``tp_serve``: graphed, K1 n x layers x requests and ``name`` n x
    layers x steps at (1, the shard's rows), each shard's pool bytes
    ``pool_report``'s, one capture, the first request graphed == op by op)
    against ``single``, phase 16's single-device serve of the same
    requests ((record, report, rows) of ``moe_serve``): tier (b) at
    MOE_TP_TOL, and the routed assignments of the first request's op-by-op
    serve that differ from the single-device one's, printed. Returns the
    runs, their engines kept for ``tp_finish``."""
    from repro_torch.serving.options import ServeOptions

    cfg = model.cfg
    arch = cfg.name
    rec, rep, rows = single
    base = {"rep": rep, "rows": rows, "params": params}
    runs = {}
    for n in MOE_TP_SHARDS[arch]:
        run = tp_serve(f"{arch} serve, {cfg.n_layers} layers, {n} shards", model, params, reqs,
                       ServeOptions(**TP_OPTIONS), n, name, base=base, tol=MOE_TP_TOL[arch],
                       routes=True)
        run["routes_vs_single_device"] = d = routes_differ(run.pop("routes"), rec["routes"],
                                                           cfg)
        print(f"  {arch}, {n} shards: routed assignments of the first request's op-by-op serve "
              f"that differ from the single-device serve's: {d['differ']} of "
              f"{d['assignments']} (its prefill and decode steps up to its first token "
              f"divergence, step {d['token_divergence']}: {d['forwards_compared']} forwards)",
              flush=True)
        runs[f"{arch} TP {n}"] = run
    return runs


def a2a_layer(model, params, gate=True, factors=(A2A_NO_DROP, A2A_DROPS)):
    """(g), the ``"a2a"`` dispatch on the card, on dbrx-132b's first MoE
    layer and (d)'s 512-token input (16 segments of 128 assignments):
    (1) card against the port's CPU path (bf16) at capacity A2A_DROPS:
    expert ids equal over MOE_MARGIN, each assignment's per-segment slot or
    drop equal wherever no token before it in its segment routed
    otherwise, dropped assignments among them, the output RMS over the
    tokens routed alike within MOE_LAYER_RMS_TOL; (2) at A2A_NO_DROP a2a ==
    gather on the card, bitwise, no drop in either; (3) at A2A_DROPS a2a
    drops assignments gather keeps and its outputs differ; (4) the router's
    logits from its expert columns split over 2 and 4 shards and gathered,
    against the whole product: the routed assignments they would move at
    the prefill's 512 rows and at a decode step's 8 (printed: the sharded
    forward runs the router whole, ``models/tensor_parallel.py``).
    ``factors``: the capacity factors of (2) and (3) to run. Returns the
    record with its gates; with ``gate`` a failing gate fails."""
    import dataclasses

    from repro_torch.distributed.collectives import all_gather
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx, dense_apply
    from repro_torch.models.transformer import layer_params

    cfg = dataclasses.replace(model.cfg, moe_impl="a2a")
    k, e = cfg.moe_top_k, cfg.n_experts
    lp = layer_params(params["stack"]["layers"], 0)
    ctx, cpu_ctx = model.prefill_ctx, Ctx(dtype=torch.bfloat16)
    h = moe_layer_input(model, params, MOE_EMBED_STD)
    s = h.shape[1]
    g, c_seg = moe.groups(dataclasses.replace(cfg, capacity_factor=A2A_DROPS), s)
    seg = s // g                                        # tokens a segment
    out = {"tokens": s, "segments": g, "c_seg": c_seg}
    with torch.no_grad():
        drops_cfg = dataclasses.replace(cfg, capacity_factor=A2A_DROPS)
        y_card, _ = moe.moe_apply(lp["ffn"], h, drops_cfg, ctx)
        c, t_card, _, _ = moe._route(lp["ffn"], h, drops_cfg, ctx)
        ids_card = moe._top_k(torch.softmax((h @ lp["ffn"]["router"]["w"]).float(), -1),
                              k)[1].cpu()[0]
        ffn_cpu, x_cpu = _tree_to(lp["ffn"], "cpu"), h.cpu()
        y_cpu, _ = moe.moe_apply(ffn_cpu, x_cpu, drops_cfg, cpu_ctx)
        _, t_cpu, _, _ = moe._route(ffn_cpu, x_cpu, drops_cfg, cpu_ctx)
        probs_cpu = torch.softmax((x_cpu @ ffn_cpu["router"]["w"]).float(), -1)
    top = torch.sort(probs_cpu[0], -1, descending=True).values
    wide = top[:, k - 1] - top[:, k] > MOE_MARGIN
    ids_cpu = moe._top_k(probs_cpu, k)[1][0]
    member = lambda ids: torch.zeros((ids.shape[0], e), dtype=torch.int32).scatter_(1, ids, 1)
    moved = (member(ids_card) != member(ids_cpu)).int().reshape(g, seg, e)
    differs = (torch.cumsum(moved, 1) > 0).reshape(s, e)  # a token up to here in its segment
    alike = (ids_card == ids_cpu) & ~differs.gather(1, ids_card)
    tc, th = t_card.cpu()[0].reshape(-1, k), t_cpu[0].reshape(-1, k)
    tok_alike = alike.all(-1)
    d = (y_card.float().cpu()[0] - y_cpu.float()[0])[tok_alike]
    rms = float(d.pow(2).mean().sqrt()) / float(y_cpu.float()[0][tok_alike].pow(2).mean().sqrt())
    out["card_vs_cpu"] = {
        "capacity_factor": A2A_DROPS, "c_seg": c, "under_margin": int((~wide).sum()),
        "ids_equal_over_margin": bool(torch.equal(ids_card[wide], ids_cpu[wide])),
        "assignments_compared": int(alike.sum()),
        "drops_compared": int((th[alike] == e * c).sum()),
        "drop_share": float((t_cpu == e * c).float().mean()),
        "slots_equal": bool(torch.equal(tc[alike], th[alike])),
        "tokens_routed_alike": int(tok_alike.sum()), "max_abs_diff": float(d.abs().max()),
        "rms_rel": rms}
    cc = out["card_vs_cpu"]
    print(f"  {cfg.name} MoE layer under a2a ({g} segments of {seg * k} assignments, C_seg "
          f"{c} at capacity {A2A_DROPS}), card vs CPU (bf16) on {s} tokens: "
          f"{cc['drop_share']:.2%} dropped; {cc['under_margin']} tokens under the margin; ids "
          f"equal over it: {cc['ids_equal_over_margin']}; per-segment slots and drops equal on "
          f"the {cc['assignments_compared']} assignments routed alike up to them in their "
          f"segment ({cc['drops_compared']} dropped): {cc['slots_equal']}; output over the "
          f"{cc['tokens_routed_alike']} tokens routed alike: max |diff| "
          f"{cc['max_abs_diff']:.4g}, RMS {rms:.4g} of the CPU output's (limit "
          f"{MOE_LAYER_RMS_TOL})", flush=True)
    # a2a against gather on the card, without and with drops
    with torch.no_grad():
        for factor in factors:
            ys, drops = {}, {}
            for impl in ("gather", "a2a"):
                f_cfg = dataclasses.replace(cfg, moe_impl=impl, capacity_factor=factor)
                ys[impl] = moe.moe_apply(lp["ffn"], h, f_cfg, ctx)[0]
                c_i, t_i, _, _ = moe._route(lp["ffn"], h, f_cfg, ctx)
                drops[impl] = int((t_i == e * c_i).sum())
            out[f"a2a_vs_gather_cf{factor:g}"] = {
                "drops": drops, "bitwise": bool(torch.equal(ys["a2a"], ys["gather"])),
                "max_abs_diff": float((ys["a2a"].float() - ys["gather"].float()).abs().max())}
            r = out[f"a2a_vs_gather_cf{factor:g}"]
            print(f"  {cfg.name} MoE layer on the card, capacity {factor:g}: a2a vs gather "
                  f"drops {drops}, outputs bitwise equal {r['bitwise']}, max |diff| "
                  f"{r['max_abs_diff']:.4g}", flush=True)
        # the router from its expert columns split over shards
        x_step = h[0, :8][:, None]                              # a decode step's 8 rows
        w = lp["ffn"]["router"]["w"]
        moved = {}
        for label, x, c_ in (("prefill 512 rows", h, ctx), ("decode 8 rows", x_step,
                                                            model.step_ctx)):
            whole = moe._top_k(torch.softmax(dense_apply({"w": w}, x, c_).float(), -1), k)[1]
            for n in (2, 4):
                cols = all_gather([dense_apply({"w": w[:, i * e // n:(i + 1) * e // n]}, x, c_)
                                   for i in range(n)], -1)
                ids = moe._top_k(torch.softmax(cols.float(), -1), k)[1]
                moved[f"{label}, {n} shards"] = int(
                    (member(ids.reshape(-1, k).cpu()).bool()
                     & ~member(whole.reshape(-1, k).cpu()).bool()).sum())
    out["router_column_slices_moved"] = moved
    print(f"  {cfg.name} router, expert columns split over shards and gathered against the "
          f"whole product: routed assignments moved {moved} ({card_line()})", flush=True)
    gates = {"card_vs_cpu": cc["ids_equal_over_margin"] and cc["slots_equal"]
             and cc["drops_compared"] > 0 and rms <= MOE_LAYER_RMS_TOL}
    if A2A_NO_DROP in factors:
        nd = out[f"a2a_vs_gather_cf{A2A_NO_DROP:g}"]
        gates["a2a_equals_gather_without_drops"] = nd["bitwise"] and not any(
            nd["drops"].values())
    if A2A_DROPS in factors:
        dr = out[f"a2a_vs_gather_cf{A2A_DROPS:g}"]
        gates["a2a_drops_otherwise"] = (dr["drops"]["a2a"] > dr["drops"]["gather"]
                                        and dr["max_abs_diff"] > 0)
    out["gates"] = gates
    print(f"  {cfg.name} a2a gates: {gates}", flush=True)
    if gate:
        check(all(gates.values()), f"{cfg.name} a2a on the card: gates fail: {gates}")
    return out


def a2a_serves(model, params, reqs):
    """(g)'s serve: the first MOE_A2A_REQUESTS of ``reqs`` under
    moe_impl="a2a" (the prefills and tails of the trace take the segment
    path: S * k divisible by 16; a decode step the fallback),
    single-device and over 2 shards on cuda:0, the
    sharded serve against the single-device one at tier (b). Returns the
    two runs (engines kept for ``tp_finish``)."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serving.options import ServeOptions

    m = Model(dataclasses.replace(model.cfg, moe_impl="a2a"), device=model.device)
    reqs = reqs[:MOE_A2A_REQUESTS]
    lens = sorted({r.prompt_len for r in reqs})
    print(f"  {m.cfg.name} a2a serve: prompt lengths {lens} route in "
          f"{[moe.groups(m.cfg, n)[0] for n in lens]} groups (C {[moe.groups(m.cfg, n)[1] for n in lens]}); "
          f"a decode step in {moe.groups(m.cfg, 1)[0]}", flush=True)
    opts = ServeOptions(**TP_OPTIONS)
    one = tp_serve(f"{m.cfg.name} a2a serve, single-device", m, params, reqs, opts, 1, "K2",
                   timed=False)
    two = tp_serve(f"{m.cfg.name} a2a serve, 2 shards", m, params, reqs, opts, 2, "K2",
                   base=one["rec"], timed=False, tol=MOE_TP_TOL[m.cfg.name])
    return {f"{m.cfg.name} a2a": one, f"{m.cfg.name} a2a TP 2": two}


def _tp_done(runs):
    for run in runs.values():
        run.pop("rec", None)
    return runs


def phase16_moe():
    """The MoE family at full width, MOE_LAYERS layers (phase 16): (a)
    dbrx-132b generate, (b) dbrx-132b served plain and speculatively
    (GQA 48/8 on K2), (d) its MoE layer card against CPU, (e) (b)'s serve
    over 2 and 4 shards (experts split over them), (g) the a2a dispatch
    (its layer card against CPU and against gather, a serve over 2 shards);
    (c) deepseek-v2-236b served (MLA at 128 heads on K4), (f) over 2
    shards."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.scheduler import shared_prefix_trace

    t_phase = time.perf_counter()
    card = card_line()
    out = {}
    model, params = moe_model("dbrx-132b")
    cfg = model.cfg
    print(f"MoE: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters at "
          f"{cfg.n_layers} of {get_config(cfg.name).n_layers} layers; d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads, {cfg.n_experts} experts top-"
          f"{cfg.moe_top_k}, d_ff_expert {cfg.d_ff_expert}), bf16 seeded weights, embedding "
          f"std {MOE_EMBED_STD}, softmax int_pallas ({card})", flush=True)
    out["dbrx generate"] = moe_generate(model, params)
    reqs = shared_prefix_trace(32, cfg.vocab, **SERVE_TRACE)[:MOE_REQUESTS]
    single = moe_serve(model, params, reqs, "K2", cfg.n_heads // cfg.n_kv_heads)
    rec, plain, rows = single
    out["dbrx serve"] = rec
    out["dbrx spec serve"] = moe_spec(model, params, reqs, plain, rows)
    out["dbrx layer card vs cpu"] = moe_layer_card_vs_cpu(model, params)
    # (e) expert parallelism over 2 and 4 shards, (g) the a2a dispatch
    runs = moe_sharded(model, params, reqs, single, "K2")
    out["dbrx a2a layer"] = a2a_layer(model, params)
    runs.update(a2a_serves(model, params, reqs))
    tp_finish("phase 16 (e), (g)", list(runs.values()))
    out["sharded"] = _tp_done(runs)
    rec.pop("routes")
    del model, params, single, plain, rows, runs
    torch.cuda.empty_cache()
    model, params = moe_model("deepseek-v2-236b")
    cfg = model.cfg
    print(f"MoE: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters at "
          f"{cfg.n_layers} of {get_config(cfg.name).n_layers} layers: {cfg.n_dense_prefix} dense, "
          f"{cfg.n_layers - cfg.n_dense_prefix} MoE; MLA {cfg.n_heads} heads, kv_lora "
          f"{cfg.kv_lora_rank}, q_lora {cfg.q_lora_rank}, rope {cfg.qk_rope_dim}; "
          f"{cfg.n_experts} experts top-{cfg.moe_top_k}, {cfg.n_shared_experts} shared, "
          f"d_ff_expert {cfg.d_ff_expert}), bf16 seeded weights, embedding std "
          f"{MOE_EMBED_STD}, softmax int_pallas ({card})", flush=True)
    reqs = shared_prefix_trace(32, cfg.vocab, **SERVE_TRACE)[:MOE_REQUESTS]
    single = moe_serve(model, params, reqs, "K4", cfg.n_heads)
    out["deepseek-v2 serve"] = single[0]
    # (f) expert parallelism over 2 shards, K4 at 64 heads a shard
    runs = moe_sharded(model, params, reqs, single, "K4")
    tp_finish("phase 16 (f)", list(runs.values()))
    out["sharded"].update(_tp_done(runs))
    single[0].pop("routes")
    del model, params, single, runs
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


# ----------------------------------------------------------------- phase 17

# The recurrent families at full width (item 11's SSM and hybrid bullets):
# mamba2-780m (SSD layers, no attention: no kernel) and hymba-1.5b (layers
# of attention + SSM heads; 3 global layers paged through K2 at GQA 25/5, D
# 64; the window layers decoding from rings of 1024 keys through K1). Prompts stay on the SSD chunk grid (at most 256
# tokens, or a multiple of 256: ``ssm.ssd_chunked``'s rule).
REC_ARCHS = ("mamba2-780m", "hymba-1.5b")
# Depth on the card: a quarter of each model's (48 SSD layers, 32 hybrid
# layers), at full width: half since PR 27 made room for phase 19, a
# quarter since PR 30 for phase 16's sharded serves (PERF.md §6, PR 30:
# the phase's seconds before and after). hymba-1.5b at 8 layers keeps its
# 3 global layers (0, 4, 7) and 5 window layers; every launch count and
# check follows the config.
REC_LAYERS = {"mamba2-780m": 12, "hymba-1.5b": 8}
REC_BATCH, REC_MAX_NEW, REC_OP_STEPS = 4, 256, 32
REC_PROMPT = {"mamba2-780m": 256, "hymba-1.5b": 1280}
REC_TRACE = dict(prefix_len=128, suffix_lens=(64, 128), max_new_range=(16, 64), seed=0,
                 arrival_spacing=2.0)
REC_REQUESTS = 8
# (d)'s pool: this many requests' worst case (20 blocks of 16 tokens), so
# the class-0 arrivals find it full and swap a class-1 request out
REC_POOL_REQUESTS = 3
# Decoded logits against ``Model.train_logits`` over the whole generated
# sequence, (max, RMS) of |decoded - forward| over every logit of every
# step. The two sides differ by the recurrence's arithmetic: decode steps
# the SSM state in f32 one token at a time and reads the window from a
# ring, the forward runs the chunked SSD scan (bf16 products within a
# chunk) and the window mask over positions; hymba also by the GEMM shapes
# of a 4-row step against a 1536-row forward. On the H100 at REC_LAYERS'
# depth the runs read max 0.1875, RMS 0.02919 (mamba2-780m: 12 layers of
# f32 recurrence against bf16 chunk products) and max 0.1094, RMS 0.01952
# (hymba-1.5b); each limit is 1.3 times its floor (PERF.md §6, PR 30; at
# half depth, PR 25-29: 0.2681 / 0.04359 and 0.1553 / 0.0258). The
# control (REC_FAULTS: the decode step without its D skip) must fail them:
# at this depth it reads 6.891 / 1.223 and 6.375 / 1.057.
# In f32 on the CPU the two sides agree within 1e-5
# (tests/test_torch_hybrid.py).
REC_GEN_TOL = {"mamba2-780m": (1.3 * 0.1875, 1.3 * 0.02919),
               "hymba-1.5b": (1.3 * 0.1094, 1.3 * 0.01952)}


def rec_model(arch, kind="int_pallas"):
    """Full-width ``arch`` at REC_LAYERS' depth with seeded random bf16
    weights on the card, softmax ``kind``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model

    model = Model(get_config(arch, softmax=SoftmaxSpec(kind), n_layers=REC_LAYERS[arch]))
    return model, model.init(torch.Generator("cuda").manual_seed(0))


class _BatchRows:
    """Greedy sampler of ``Engine.generate`` keeping every [B, V] logits row
    it samples (it draws nothing: its argmax is the registry's greedy)."""

    def __init__(self):
        self.rows = []

    def __call__(self, logits, generator):
        self.rows.append(logits.clone())
        return torch.argmax(logits, dim=-1).to(torch.int32)


def ring_positions_match(cfg, st_cache, last: int) -> bool:
    """hymba: the positions the decode steps left in every window layer's
    ring, bitwise against the ring of a sequence decoded through position
    ``last``: slot i holds the latest position q <= last with q % W == i."""
    ok = True
    for seg in ("win_a", "win_b"):
        pos = st_cache[seg]["attn"]["pos"]
        w = pos.shape[-1]
        i = torch.arange(w, device=pos.device, dtype=torch.int32)
        want = (last - torch.remainder(last - i, w)).to(torch.int32)
        ok &= bool((pos == want).all())
    return ok


def recurrent_generate(model, params, prompts):
    """(a) / (b): ``Engine.generate(mode="fused")`` at batch 4 and
    REC_MAX_NEW new tokens, each decode step one CUDA-graph replay: K1
    n_attention_layers x REC_MAX_NEW launches (the replays' from the device
    trace), nothing else; every decoded logit row within REC_GEN_TOL of
    ``Model.train_logits`` over the generated sequence; hymba's ring
    positions as the decoded positions put them; over the first
    REC_OP_STEPS steps graph == op by op bitwise (tokens, last logits,
    state bytes) and == the long run's tokens, mamba2's == mode="eager"; for an
    attention model ``int`` == ``int_pallas`` bitwise over those steps
    (tokens, last logits); ms a step of a warm graphed generate of those
    steps beside the bytes bound, peak memory. Returns the record."""
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    cfg = model.cfg
    label = f"{cfg.name} generate"
    b, p = prompts.shape
    attn = cfg.n_layers if cfg.uses_attention else 0
    rows = _BatchRows()
    eng = Engine(model, params, max_new=REC_MAX_NEW, sampler=rows)
    torch.cuda.reset_peak_memory_stats()
    before = replay_counts(eng)
    zero_counters()
    t0 = time.perf_counter()
    res = eng.generate(prompts, mode="fused")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counted, replayed = read_counters(), replays_in(eng, before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(res.tokens.shape == (b, p + REC_MAX_NEW), f"{label}: token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()), f"{label}: token range")
    check(bool(torch.isfinite(res.logits).all()), f"{label}: non-finite logits")
    (st,) = eng._decode_states.values()
    ring = None
    if cfg.family == "hybrid":     # read before the trace's replays step the state on
        last = p + REC_MAX_NEW - 2
        ring = ring_positions_match(cfg, st.cache, last)
        print(f"  {label}: every window layer's ring after {REC_MAX_NEW - 1} decode steps "
              f"holds, in slot i, the latest position <= {last} that is i mod "
              f"{cfg.window}: {ring}", flush=True)
    bound = rl.decode_bound_ms(params, st.cache, rl.hbm_rate(torch.cuda.get_device_name(0)))
    per_replay = {k: 0 for k in counted}
    per_replay["K1"] = attn
    traces = replay_trace(label, replayed_graphs(eng, replayed))
    n = path_launches(label, counted, replayed, traces, per_replay)
    want = {k: 0 for k in n}
    want["K1"] = attn * REC_MAX_NEW
    print(f"  {label}: launches {n} (expected {want}: K1 {attn} attention layers x "
          f"{REC_MAX_NEW} (the prefill and {REC_MAX_NEW - 1} decode steps)); first call "
          f"{first_s:.2f} s (capture included), peak {peak:.2f} GiB", flush=True)
    check(n == want, f"{label}: launches {n} != {want}")
    # every decoded row against one causal forward of the generated sequence
    got = torch.stack(rows.rows, 1)                           # [B, max_new, V]
    seq = torch.as_tensor(res.tokens[:, :-1], dtype=torch.long, device="cuda")
    ref = full_logits(model, params, seq)[:, p - 1:]
    d = (got.float() - ref.float()).abs()
    tol, rms_tol = REC_GEN_TOL[cfg.name]
    tf = {"max": float(d.max()), "first_step_max": float(d[:, 0].max()),
          "rms": float(d.double().pow(2).mean().sqrt()), "limits": [tol, rms_tol]}
    del got, ref, d, rows.rows
    print(f"  {label}: decoded logits against Model.train_logits over the {p + REC_MAX_NEW}"
          f"-token sequences: max |diff| {tf['max']:.4g} (first step {tf['first_step_max']:.4g}"
          f"), RMS {tf['rms']:.4g} (limits {tol:.4g}, RMS {rms_tol:.4g})", flush=True)
    # graph == op by op == eager over the first REC_OP_STEPS steps
    g32 = Engine(model, params, max_new=REC_OP_STEPS)
    o32 = op_by_op(Engine(model, params, max_new=REC_OP_STEPS))
    g, o = g32.generate(prompts, mode="fused"), o32.generate(prompts, mode="fused")
    (sg,), (so,) = g32._decode_states.values(), o32._decode_states.values()
    eq = caches_equal(sg, so)
    graph_op = {"tokens": bool(np.array_equal(g.tokens, o.tokens)),
                "last_logits": bool(torch.equal(g.logits, o.logits)),
                "state": all(eq.values()),
                "long_run_tokens": bool(np.array_equal(g.tokens,
                                                       res.tokens[:, :p + REC_OP_STEPS]))}
    if not cfg.uses_attention:      # (a): mode="eager" too (hymba's is phase 6's path)
        e = g32.generate(prompts, mode="eager")
        graph_op["eager"] = bool(np.array_equal(e.tokens, g.tokens)
                                 and torch.equal(e.logits, g.logits))
    print(f"  {label}, first {REC_OP_STEPS} steps: graph == op by op bitwise {graph_op} "
          f"(state {cache_bytes(sg)} B over {len(eq)} leaves)", flush=True)
    del o32, sg, so
    same_int = None
    if cfg.uses_attention:
        r_int = Engine(Model(cfg.with_softmax(SoftmaxSpec("int"))), params,
                       max_new=REC_OP_STEPS).generate(prompts, mode="fused")
        same_int = bool(np.array_equal(r_int.tokens, g.tokens)
                        and torch.equal(r_int.logits, g.logits))
        print(f"  {label}: int_pallas vs int (plain Alg. 1) on the card over {REC_OP_STEPS} "
              f"steps, tokens and last logits bitwise equal: {same_int}", flush=True)
    # a warm graphed generate of REC_OP_STEPS tokens (captured above)
    # against prefill alone
    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, {"tokens": tokens}, cache_len=p + REC_OP_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g32.generate(prompts, mode="fused")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    step_ms = ((t2 - t1) - (t1 - t0)) / (REC_OP_STEPS - 1) * 1e3
    (trace,) = traces.values()
    print(f"  {label}: {step_ms:.3f} ms per decode step graphed (warm generate of "
          f"{REC_OP_STEPS} tokens {(t2 - t1) * 1e3:.1f} ms less prefill {(t1 - t0) * 1e3:.1f} "
          f"ms; one replayed step's device span {trace['span_ms']:.3f} ms) against a bytes "
          f"bound of {bound:.3f} ms (weights but the embedding, the decode state read, the SSM "
          f"state written); peak {peak:.2f} GiB ({card_line()})", flush=True)
    rec = {"arch": cfg.name, "batch": b, "prompt": p, "max_new": REC_MAX_NEW,
           "launches": n, "launches_K1": n["K1"], "teacher_forced": tf, "rings": ring,
           "graph_vs_op_by_op": graph_op, "int_vs_int_pallas": same_int,
           "ms_per_step": step_ms, "prefill_ms": (t1 - t0) * 1e3, "bytes_bound_ms": bound,
           "peak_gib": peak, "step_trace": trace}
    fails = {"launches": n != want, "logit_max": tf["max"] > tol, "logit_rms": tf["rms"] > rms_tol,
             "graph_vs_op": not all(graph_op.values()),
             "int_vs_int_pallas": same_int is False,
             "ring_positions": ring is False}
    rec["failing_checks"] = [k for k, v in fails.items() if v]
    return rec


# hymba-1.5b's serve (c) against a teacher-forced pass and, step by step,
# pallas against jnp: phase 6's rules with the floors this model reads on
# the H100, where the window layers' rings and the SSM recurrence add
# roundings olmo-1b's serve does not have. The largest sound readings at
# REC_LAYERS' depth (PERF.md §6, PR 30), each limit 1.3 times its own: a
# logit against the forward max 0.125 (the pallas and jnp serves' decode
# steps), RMS 0.02323 (a per-request eager generate); pallas against jnp
# step by step max 0.09375, RMS 0.01269. The control (K2 leaving out each
# sequence's first page) reads max 2.085, RMS 0.3344 (at half depth, PR
# 25-29: limits from 0.1777 / 0.03221 and 0.1172 / 0.0165).
HYMBA_LOGIT_TOL = 1.3 * 0.125
HYMBA_LOGIT_RMS_TOL = 1.3 * 0.02323
HYMBA_ALIGNED_TOL = 1.3 * 0.09375
HYMBA_ALIGNED_RMS_TOL = 1.3 * 0.01269


def swap_round_trip_nested(cfg, num_blocks, slots=8, C=1024, bs=16):
    """swap_read -> host -> swap_write on a full-width paged cache of random
    contents (pools, SSM state and conv tails, rings): the slot's stripes
    zeroed between (another occupant), the blocks restored into other ids;
    every restored block and stripe equal to the original, every other
    slot's stripes untouched, the table row as given."""
    from repro_torch.launch import roofline as rl
    from repro_torch.models import kv_cache

    slot = 2
    cache = kv_cache.paged_cache_zeros(cfg, slots, C, bs, num_blocks, device="cuda")
    g = torch.Generator("cuda").manual_seed(13)
    for _, leaf in rl.named_leaves(cache):
        if leaf.dtype == torch.int32:
            if leaf.dim() == 3 and leaf.shape[-1] != C // bs:      # ring positions
                leaf.copy_(torch.randint(-1, 4096, leaf.shape, generator=g, device="cuda",
                                         dtype=torch.int32))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda"))
    rng = np.random.default_rng(13)
    picked = rng.permutation(num_blocks)[:12].tolist()
    ids, new_ids = picked[:5], picked[5:10]
    row = np.full((C // bs,), num_blocks, np.int32)
    row[:5] = new_ids
    pools = kv_cache._paged_nodes(cache)
    before_blocks = [{k: v[:, ids].clone() for k, v in node.items() if k != "table"}
                     for node in pools]
    stripes = [(k, v) for k, v in rl.named_leaves(cache)
               if not k.split("/")[-1] in ("table",) and not any(
                   v is node[q] for node in pools for q in node)]
    before_slot = {k: v[:, slot].clone() for k, v in stripes}
    before_rest = {k: torch.cat([v[:, :slot], v[:, slot + 1:]], 1).clone() for k, v in stripes}
    payload = kv_cache.swap_read(cache, slot, ids)
    host = all(v.device.type == "cpu" for _, v in rl.named_leaves(payload))
    for _, v in stripes:
        v[:, slot].zero_()
    kv_cache.swap_write(cache, payload, slot, new_ids, row)
    equal = {}
    for i, node in enumerate(pools):
        for k, v in before_blocks[i].items():
            equal[f"pool {i} {k}"] = bool(torch.equal(node[k][:, new_ids], v))
    for k, v in stripes:
        equal[k] = bool(torch.equal(v[:, slot], before_slot[k])) and bool(torch.equal(
            torch.cat([v[:, :slot], v[:, slot + 1:]], 1), before_rest[k]))
    table = all(bool((node["table"][:, slot].cpu() == torch.from_numpy(row)).all())
                for node in pools)
    nbytes = sum(v.numel() * v.element_size() for _, v in rl.named_leaves(payload))
    ok = host and table and all(equal.values())
    print(f"  swap round trip, {cfg.name} paged cache of {num_blocks} blocks: {len(ids)} blocks "
          f"and slot {slot}'s stripes ({nbytes} B) to the host and back (blocks into other "
          f"ids, the slot's stripes zeroed between): restored and untouched "
          f"{'all equal' if all(equal.values()) else equal}, table rows as given {table}",
          flush=True)
    return {"ok": ok, "blocks": len(ids), "bytes": nbytes, "equal": equal, "table": table}


def recurrent_chunked_preempt(model, params, reqs, kernel, plain, plain_rows):
    """(d) The trace with every fourth request in class 0, served with
    ``prefill_chunk=128`` (the staged branch: the budget accrues, then one
    whole prefill) and ``preemption=True`` from a pool of REC_POOL_REQUESTS
    requests' worst case, graphed: at least one preemption and as many
    resumes, no leaked blocks, tokens and every logit row bitwise equal to
    the plain serve's (``plain``: the same prompts in one class, the same
    options and kernel without chunks or preemption); beside it the swap
    round trip of the full-width cache (blocks and stripes)."""
    import dataclasses

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    cfg = model.cfg
    bs = SERVE_OPTIONS["block_size"]
    worst = max(-(-(r.prompt_len + r.max_new) // bs) for r in reqs)
    opts = ServeOptions(**{**SERVE_OPTIONS, "report_cost": False, "kernel": kernel},
                        prefill_chunk=CHUNK, preemption=True,
                        num_blocks=REC_POOL_REQUESTS * worst)
    swap = swap_round_trip_nested(cfg, opts.num_blocks)
    lr = _LogitRecorder()
    eng = Engine(model, params, max_new=max(r.max_new for r in reqs), sampler=lr)
    rep, counted, rows, wall, _ = counted_serve(eng, reqs, opts, lr)
    same = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                          for a, b in zip(rep.results, plain.results)),
            "logit_rows": rows_equal(rows, plain_rows) == len(reqs)}
    gates = {"preempted": rep.preemptions >= 1 and rep.resumes == rep.preemptions,
             "no_leaked_blocks": rep.leaked_blocks == 0, "swap_round_trip": swap["ok"],
             "equal_to_plain": all(same.values())}
    print(f"  {cfg.name} chunked ({CHUNK}, staged) + preempting serve, pool of "
          f"{opts.num_blocks} blocks, kernel {kernel}: {rep.steps} steps (plain {plain.steps}), "
          f"preemptions {rep.preemptions}, resumes {rep.resumes}, max prompt tokens in a step "
          f"{rep.max_prefill_per_step}, leaked {rep.leaked_blocks}, launches {counted}; == "
          f"plain serve bitwise {same}; gates {gates}", flush=True)
    return {"steps": rep.steps, "preemptions": rep.preemptions, "resumes": rep.resumes,
            "max_prompt_tokens_per_step": rep.max_prefill_per_step, "launches": counted,
            "equal_to_plain": same, "swap": swap, "gates": gates, "wall_s": wall,
            "failing_checks": [k for k, v in gates.items() if not v]}


def recurrent_spec(model, params, reqs, kernel, plain, plain_rows):
    """(e) The speculative serve (n-gram drafts of SPEC_K), graphed, each
    round one replay: tokens and every served logit row bitwise equal to the
    plain serve's; launches K2 3 x rounds, every call at (SPEC_K + 1, 5 x
    (SPEC_K + 1)) (hymba), K1 n_layers x requests + n_window x (SPEC_K + 1) x rounds
    (each window layer's ring scan), none for mamba2; one replay a round
    after the first; acceptance, and ms a round of a warm serve
    (``spec_timing``) beside the plain serve's warm graphed timing where
    phase 17 took it (hymba's, ``serve_phase``)."""
    from repro_torch.models.kv_cache import hybrid_segments
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    cfg = model.cfg
    label = f"{cfg.name} spec serve"
    t = SPEC_K + 1
    opts = ServeOptions(**{**SERVE_OPTIONS, "report_cost": False, "kernel": kernel},
                        speculative=True, draft="ngram", draft_k=SPEC_K)
    max_new = max(r.max_new for r in reqs)
    eng = Engine(model, params, max_new=max_new)
    rec = SpecRecorder(eng)
    with KernelWidths() as widths:
        rep, counted, _, first_s, replayed = counted_serve(eng, reqs, opts, rec)
    rows = rec.trimmed(reqs)
    rec.detach()
    same = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                          for a, b in zip(rep.results, plain.results)),
            "logit_rows": rows_equal(rows, plain_rows) == len(reqs)}
    per_replay = {k: 0 for k in counted}
    want = {k: 0 for k in counted}
    if cfg.family == "hybrid":
        n_win = sum(hybrid_segments(cfg))
        per_replay.update({"K2": 3, "K1": n_win * t})
        want.update({"K2": 3 * rep.steps, "K1": cfg.n_layers * len(reqs) + n_win * t * rep.steps})
    if cfg.uses_attention:
        traces = replay_trace(label, replayed_graphs(eng, replayed))
        n = path_launches(label, counted, replayed, traces, per_replay)
        trace = next(iter(traces.values()))
    else:       # no attention, so no kernel in the round (its generate step is traced)
        n, trace = counted, None
    w = widths.widths("K2")
    want_w = [(t, t * cfg.n_heads // cfg.n_kv_heads)] if cfg.family == "hybrid" else []
    # one replay a round: the first round warms up and captures the graph
    one_replay = rep.step_replays == rep.steps - 1
    print(f"  {label}: {rep.steps} rounds against the plain serve's {plain.steps} steps, "
          f"drafted {rep.drafted_tokens}, accepted {rep.accepted_tokens}, acceptance rate "
          f"{rep.acceptance_rate:.4f}; launches {n} (expected {want}); K2 calls at (T, rows) "
          f"{w} (expected {want_w}); == plain serve bitwise {same}; first serve "
          f"{first_s:.2f} s, {rep.step_replays} replays (one a round after the first: "
          f"{one_replay})", flush=True)
    gates = {"equal_to_plain": all(same.values()), "launches": n == want,
             "k2_widths": w == want_w, "one_replay_a_round": one_replay}
    timing = spec_timing(label, eng, reqs, opts,
                         PLAIN_SERVES.get((cfg.name, False), {}).get("timing"), runs=1)
    return {"rounds": rep.steps, "plain_steps": plain.steps,
            "acceptance_rate": rep.acceptance_rate, "launches": n, "kernel_widths": w,
            "equal_to_plain": same, "timing": timing, "first_serve_s": first_s,
            "gates": gates,
            "failing_checks": [k for k, v in gates.items() if not v], "step_trace": trace}


def rec_trace(vocab, classes=False):
    import dataclasses

    from repro_torch.serving.scheduler import shared_prefix_trace

    reqs = shared_prefix_trace(REC_REQUESTS, vocab, **REC_TRACE)
    if classes:
        reqs = [dataclasses.replace(r, priority=0 if r.rid % 4 == 0 else 1) for r in reqs]
    return reqs


def rec_plain(model, params, reqs, kernel):
    """The plain serve of ``reqs`` (phase 6's options and ``kernel``), graphed:
    (report, logit rows)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    lr = _LogitRecorder()
    eng = Engine(model, params, max_new=max(r.max_new for r in reqs), sampler=lr)
    opts = ServeOptions(**{**SERVE_OPTIONS, "report_cost": False, "kernel": kernel})
    rep, _, rows, _, _ = counted_serve(eng, reqs, opts, lr)
    return rep, rows


def phase17_recurrent():
    """The recurrent families at full width, REC_LAYERS deep (phase 17): (a)
    mamba2-780m generate, (b) hymba-1.5b generate, (c) hymba-1.5b serve
    through K2 (D 64, GQA 25/5) and K1, (d) both chunked and preempting,
    (e) both served speculatively. Every gate is checked at the end."""
    from repro_torch.data.synthetic import SyntheticCorpus

    t_phase = time.perf_counter()
    card = card_line()
    out, failing = {}, {}
    for arch in REC_ARCHS:
        model, params = rec_model(arch)
        cfg = model.cfg
        print(f"recurrent: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B "
              f"parameters, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.ssm_nheads} SSM "
              f"heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}"
              + (f", attention {cfg.n_heads} / {cfg.n_kv_heads} heads x {cfg.d_head}, window "
                 f"{cfg.window}" if cfg.uses_attention else ", no attention") +
              f"), bf16 seeded weights, softmax int_pallas ({card})", flush=True)
        p = REC_PROMPT[arch]
        prompts = SyntheticCorpus(cfg.vocab, seed=1234).sample(REC_BATCH, p, seed=777)[:, :p]
        gen = out[f"{arch} generate"] = recurrent_generate(model, params, prompts)
        failing[f"{arch} generate"] = gen["failing_checks"]
        kernel = "pallas" if cfg.uses_attention else "jnp"
        reqs = rec_trace(cfg.vocab)
        if cfg.uses_attention:
            from repro_torch.kernels.paged_attention import ops as paged_ops
            from repro_torch.serving.options import ServeOptions

            out[f"{arch} serve"] = serve_phase(
                arch, reqs, ServeOptions(**SERVE_OPTIONS), fused=paged_ops.paged_attention_rows,
                eager_n=1, logit_tol=HYMBA_LOGIT_TOL, logit_rms_tol=HYMBA_LOGIT_RMS_TOL,
                aligned_tol=HYMBA_ALIGNED_TOL, aligned_rms_tol=HYMBA_ALIGNED_RMS_TOL,
                max_new=max(r.max_new for r in reqs), model=model, params=params,
                control=True)
            got = PLAIN_SERVES[arch, False]
            plain, plain_rows = got["rep"], got["rows"]
        else:
            plain, plain_rows = rec_plain(model, params, reqs, kernel)
        spec = out[f"{arch} spec serve"] = recurrent_spec(model, params, reqs, kernel, plain,
                                                          plain_rows)
        failing[f"{arch} spec serve"] = spec["failing_checks"]
        # (d) against the plain serve of the same prompts: a row's bits do
        # not depend on its class or slot (phase 13 relies on the same)
        ch = out[f"{arch} chunked + preempting"] = recurrent_chunked_preempt(
            model, params, rec_trace(cfg.vocab, classes=True), kernel, plain, plain_rows)
        failing[f"{arch} chunked + preempting"] = ch["failing_checks"]
        del model, params, plain, plain_rows
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 17 in {out['seconds']:.1f} s ({card})", flush=True)
    check(not any(failing.values()), f"phase 17: failing checks {failing}")
    return out


# ----------------------------------------------------------------- phase 18

# whisper-base serving: Whisper's 30 s window, 1500 frames a request (3000
# mel frames after the stride-2 conv, [arXiv:2212.04356]), one shared frame
# shape as the reference requires; 8 requests with prompts of 4-32 tokens
# and 32-64 new tokens through the contiguous executor at 4 slots
# (kernel="jnp": the reference serves nothing else for encdec).
WHISPER_ENC_LEN = 1500
WHISPER_REQUESTS, WHISPER_SLOTS = 8, 4
# Served logits against a teacher-forced ``_encdec_logits`` pass (the
# served tokens fed back through one causal decoder pass over the same
# frames), max and RMS of |served - forced| over every logit: the two
# sides differ by the GEMM shapes of a 4-slot step against a whole-sequence
# pass. On the H100 the serve read max 0.0254, RMS 0.00429, and a serve
# whose slots read their neighbours' cross K/V max 1.48, RMS 0.0706; the
# limits are 1.3 times the sound reading (PERF.md, phase 18).
WHISPER_LOGIT_TOL, WHISPER_LOGIT_RMS_TOL = 0.033, 0.0056

# qwen2-vl-7b: generate at batch 4, prompt 512, 32 new tokens (phase 4's
# cell), then phase 6's trace cut to QWEN_REQUESTS requests, 16-32 new
# tokens, paged from the bf16 pool with kernel="pallas" (K2 at GQA 28/4,
# group 7) and no prefix sharing (the reference refuses it for M-RoPE).
QWEN_REQUESTS = 8
# The QKV biases drawn N(0, QWEN_BIAS_STD) (the init draws them zero, as
# the reference's; a zero bias would leave their add unseen on the card).
QWEN_BIAS_STD = 0.1
# The serve is held to phase 6's limits themselves (LOGIT_TOL, RMS
# LOGIT_RMS_TOL against a teacher-forced pass; LOGIT_TOL, RMS
# ALIGNED_RMS_TOL pallas against jnp step by step): on the H100 its sound
# readings were max 0.0898, RMS 0.0161 (eager floor 0.0859, 0.0159) and
# step by step 0.0938, RMS 0.0150, and the control (K2 leaving out each
# sequence's first page) read max 0.664, RMS 0.104 (PERF.md, phase 18).


def whisper_trace(cfg):
    """WHISPER_REQUESTS requests, two arriving every 2 steps, each with its
    own seeded frames [WHISPER_ENC_LEN, d_model] (standard normal, the stub
    frontend's output)."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(WHISPER_REQUESTS):
        p = int(rng.integers(4, 33))
        prompt = rng.integers(0, cfg.vocab, p).astype(np.int32)
        max_new = int(rng.integers(32, 65))
        frames = rng.standard_normal((WHISPER_ENC_LEN, cfg.d_model)).astype(np.float32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=max_new, arrival=2.0 * (i // 2),
                            seed=1000 + i, frames=frames))
    return reqs


def _within(stats, tol, rms_tol):
    return max(stats["first_step_max"], stats["decode_max"]) <= tol and \
        stats["rms"] <= rms_tol


def whisper_serve(model, params, reqs):
    """whisper-base through ``Engine.serve`` (contiguous, kernel="jnp", 4
    slots): every served stream equal to its per-request eager generate
    with the same frames, tokens and every logit row bitwise; K1 3 x 6 a
    prefill (encoder, self, cross) and 2 x 6 a replayed step (the replays'
    from the device trace); the first SERVE_OP_SUBSET requests graphed
    == op by op bitwise (tokens, logit rows, cache bytes, cross K/V
    included); ``int`` == ``int_pallas`` bitwise (tokens, every logit
    row); every served logit within the WHISPER limits of a teacher-forced
    ``_encdec_logits`` pass. Returns the record with its failing checks
    (the phase gates them)."""
    import dataclasses

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    cfg = model.cfg
    label = f"{cfg.name} serve"
    max_new = max(r.max_new for r in reqs)
    opts = ServeOptions(slots=WHISPER_SLOTS, report_cost=True)
    failing = []
    rec = _LogitRecorder()
    eng_r = Engine(model, params, max_new=max_new, sampler=rec)
    torch.cuda.reset_peak_memory_stats()
    rep, counted, rows, first_s, replayed = counted_serve(eng_r, reqs, opts, rec)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(rep.results) == len(reqs), f"{label}: not every request completed")
    for r, res in zip(reqs, rep.results):
        check(res.tokens.shape == (r.prompt_len + r.max_new,)
              and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              f"{label}, request {r.rid}: token shape or range")
        check(all(bool(torch.isfinite(x).all()) for x in rows[r.seed]),
              f"{label}, request {r.rid}: non-finite logits")
    check(cost_shares_sum(rep), f"{label}: cost shares do not sum to the batch meter")
    print(f"  {label}: {rep.steps} decode steps, cache_len {rep.cache_len}, encoder frames "
          f"{WHISPER_ENC_LEN} a request, prefill {rep.prefill_tokens} tokens; first serve "
          f"{first_s * 1e3:.1f} ms, peak device memory {peak:.2f} GiB; per-request cost "
          f"shares sum to the batch meter: {rep.cost.describe()}", flush=True)

    # serve == per-request eager with the same frames, every request
    rec.rows = {}
    eager_tokens = {}
    for r in reqs:
        ref = eng_r.generate(r.prompt[None], generator=torch.Generator("cuda").manual_seed(
            r.seed), mode="eager", max_new=r.max_new, cache_len=rep.cache_len,
            extra_inputs={"frames": r.frames[None]})
        eager_tokens[r.rid] = np.array_equal(ref.tokens[0], rep.by_rid()[r.rid].tokens)
    eager_rows = rec.rows
    n_rows = rows_equal(rows, eager_rows)
    serve_eager = {"tokens": sum(eager_tokens.values()), "logit_rows": n_rows,
                   "requests": len(reqs)}
    print(f"  {label} == per-request eager generate with the same frames, bitwise: requests "
          f"with equal tokens {serve_eager['tokens']} / {len(reqs)}, with every logit row "
          f"equal {n_rows} / {len(reqs)}", flush=True)
    if serve_eager["tokens"] != len(reqs) or n_rows != len(reqs):
        failing.append("serve_vs_eager")

    # graph == op by op on the first SERVE_OP_SUBSET requests
    sub = reqs[:SERVE_OP_SUBSET]
    runs = []
    for graphed in (True, False):
        r2 = _LogitRecorder()
        e2 = Engine(model, params, max_new=max_new, sampler=r2)
        if not graphed:
            op_by_op(e2)
        rep2, n2, rows2, _, _ = counted_serve(e2, sub, opts, r2)
        runs.append(((rep2, rows2, e2), n2))
    graph_vs_op = serve_graph_vs_op(f"{label}, first {len(sub)} request(s)", sub,
                                    runs[0][0], runs[1][0], gate=False)
    if not all(graph_vs_op.values()):
        failing.append("graph_vs_op_by_op")
    (rep_o, _, _), n_o = runs[1]
    del runs
    per_prefill, per_step = 3 * cfg.n_layers, 2 * cfg.n_layers
    want_o = {k: 0 for k in n_o}
    want_o["K1"] = per_prefill * len(sub) + per_step * rep_o.steps
    same_launches(f"{label}, first {len(sub)} request(s) op by op", graph_vs_op, want_o, n_o)

    # K1 launches: the wrappers' count plus the replays from the device trace
    per_replay = {k: 0 for k in counted}
    per_replay["K1"] = per_step
    traces = replay_trace(label, replayed_graphs(eng_r, replayed))
    n = path_launches(label, counted, replayed, traces, per_replay)
    want = {k: 0 for k in counted}
    want["K1"] = per_prefill * len(reqs) + per_step * rep.steps
    print(f"  launches in one {label}: {n} (expected {want}: K1 {per_prefill} a prefill "
          f"(encoder, self, cross) x {len(reqs)} + {per_step} a step (self, cross) x "
          f"{rep.steps} steps)", flush=True)
    check(n == want, f"{label}: kernel launches {n} != {want}")

    # int_pallas (K1) == int (plain Alg. 1), the same weights, bitwise
    rec.rows = {}
    rep_int = eng_r.serve(reqs, dataclasses.replace(opts, softmax_kind="int",
                                                    report_cost=False))
    int_rows = rec.rows
    int_eq = {"tokens": all(np.array_equal(a.tokens, b.tokens)
                            for a, b in zip(rep.results, rep_int.results)),
              "logit_rows": rows_equal(rows, int_rows) == len(reqs)}
    print(f"  {label}, int_pallas (K1) vs int (plain Alg. 1) on the card, bitwise: {int_eq}",
          flush=True)
    if not all(int_eq.values()):
        failing.append("int_vs_int_pallas")

    # every served logit against a teacher-forced _encdec_logits pass
    tf = teacher_forced(f"{label} (teacher-forced _encdec_logits, same frames)", model,
                        params, reqs, [res.tokens for res in rep.results], rows,
                        WHISPER_LOGIT_TOL, WHISPER_LOGIT_RMS_TOL)
    if not _within(tf, WHISPER_LOGIT_TOL, WHISPER_LOGIT_RMS_TOL):
        failing.append("teacher_forced_logits")
    captures = len(graph_states(eng_r))
    del rec, eng_r, rows, eager_rows, int_rows

    # warm serves, graphed and op by op in turns
    eng = Engine(model, params, max_new=max_new)
    eng_o = op_by_op(Engine(model, params, max_new=max_new))
    eng.serve(reqs, dataclasses.replace(opts, report_cost=False))
    timing = serve_timing(label, reqs, [("graph", eng, opts), ("op by op", eng_o, opts),
                                        ("graph", eng, opts)])
    captures += len(graph_states(eng))
    print(f"  {label}: graphs captured {captures} (one per engine and step shape: the "
          f"checked engine's int_pallas and int steps, the timed engine's one)", flush=True)
    check(captures == 3, f"{label}: {captures} graphs for 3 step shapes")
    (trace,) = traces.values()
    return {"arch": cfg.name, "requests": len(reqs), "enc_len": WHISPER_ENC_LEN,
            "slots": WHISPER_SLOTS, "steps": rep.steps, "launches": n,
            "serve_vs_eager": serve_eager, "graph_vs_op_by_op": graph_vs_op,
            "int_vs_int_pallas": int_eq, "teacher_forced_logits": tf,
            "captures": captures, "timing": timing, "peak_gib": peak, "step_trace": trace,
            "failing_checks": failing}


def image_streams(b, s, seed=0):
    """Three position streams [3, b, s] that differ, as Qwen2-VL lays out an
    image: t constant over a 2-D patch block, h and w walking its rows and
    columns, then a text ladder past the block's largest position."""
    rng = np.random.default_rng(seed)
    pos = np.empty((3, b, s), np.int32)
    grid = s // 2
    side = max(1, int(grid ** 0.5))
    for row in range(b):
        base, k = int(rng.integers(0, 64)), np.arange(grid)
        pos[:, row, :grid] = base
        pos[1, row, :grid] += k // side
        pos[2, row, :grid] += k % side
        pos[:, row, grid:] = pos[:, row, :grid].max() + 1 + np.arange(s - grid)[None]
    return pos


def qwen_distinct_streams():
    """The distinct-streams check: qwen2-vl's smoke config in f32 on the card
    against the CPU on an image-block layout of the three streams (with
    text-only streams a wrong section split cannot be seen). Returns the
    record with its failing checks."""
    def make(cfg):
        rng = np.random.default_rng(7)
        return {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
                "positions": image_streams(2, 24)}

    err, same = smoke_card_vs_cpu("qwen2-vl-7b", make)
    ok = same and err <= SMOKE_CARD_CPU_TOL
    print(f"  qwen2-vl-7b smoke f32, card vs CPU on three distinct position streams (a "
          f"12-patch image block, then text): greedy tokens equal {same}, logits max |diff| "
          f"{err:.3e} (bound {SMOKE_CARD_CPU_TOL})", flush=True)
    return {"max_abs_diff": err, "tokens_equal": same,
            "failing_checks": [] if ok else ["distinct_streams_card_vs_cpu"]}


# qwen2-vl-7b's serve at QWEN_LAYERS' depth against the teacher-forced pass
# and pallas against jnp step by step: phase 6's rules at 1.3 times the
# floors every run read on the H100 (PERF.md, phase 18): a logit max
# 0.07812 (the pallas serve), RMS 0.01262 (the pallas serve); aligned max
# 0.07031, RMS 0.01152. The control (K2 leaving out each sequence's first
# page) reads max 0.8525, RMS 0.1093.
QWEN_LOGIT_TOL, QWEN_LOGIT_RMS_TOL = 1.3 * 0.07812, 1.3 * 0.01262
QWEN_ALIGNED_TOL, QWEN_ALIGNED_RMS_TOL = 1.3 * 0.07031, 1.3 * 0.01152


def qwen_model():
    """Full-width qwen2-vl-7b at QWEN_LAYERS' depth, seeded bf16 weights on
    the card, its QKV biases drawn N(0, QWEN_BIAS_STD)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model

    model = Model(get_config("qwen2-vl-7b", softmax=SoftmaxSpec("int_pallas"),
                             n_layers=QWEN_LAYERS))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    attn = params["stack"]["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        b.copy_((torch.randn(b.shape, generator=g, device="cuda") * QWEN_BIAS_STD).to(b.dtype))
    return model, params


def qwen_trace(vocab):
    from repro_torch.serving.scheduler import shared_prefix_trace

    return shared_prefix_trace(QWEN_REQUESTS, vocab, **dict(SERVE_TRACE, max_new_range=(16, 32)))


QWEN_OPTIONS = dict(slots=8, paged=True, block_size=16, kernel="pallas", report_cost=True)


def phase18_encdec_mrope():
    """The encoder-decoder and M-RoPE families (item 11's last bullets) at
    full width: (a) whisper-base serving (``whisper_serve``) and its smoke
    config on the card against the CPU; (b) qwen2-vl-7b through the graphed
    generate (phase 4's checks, K1 14 x 32; int == int_pallas bitwise),
    served from the bf16 pool through K2 at GQA 28/4 (``serve_phase``:
    phase 6's checks and limits, graph == op by op on 1 request,
    a control failing the limits), and the distinct-streams prefill, card
    against CPU. Every gate is checked at the end."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    t_phase = time.perf_counter()
    card = card_line()
    out, failing = {}, {}

    # (a) whisper-base
    cfg = get_config("whisper-base", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    print(f"encdec: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.d_head}), bf16 seeded weights, softmax int_pallas; "
          f"{WHISPER_REQUESTS} requests of {WHISPER_ENC_LEN} frames, slots {WHISPER_SLOTS}, "
          f"kernel jnp ({card})", flush=True)
    ws = out["whisper-base serve"] = whisper_serve(model, params, whisper_trace(cfg))
    failing["whisper-base serve"] = ws["failing_checks"]
    del model, params

    def frames_batch(scfg):
        rng = np.random.default_rng(3)
        return {"tokens": rng.integers(0, scfg.vocab, (2, 8)).astype(np.int32),
                "frames": rng.standard_normal((2, 64, scfg.d_model)).astype(np.float32)}

    err, same = smoke_card_vs_cpu("whisper-base", frames_batch)
    print(f"  whisper-base smoke f32, card (K1) vs CPU (plain): greedy tokens equal {same}, "
          f"logits max |diff| {err:.3e} (bound {SMOKE_CARD_CPU_TOL})", flush=True)
    out["whisper-base smoke card vs cpu"] = {"max_abs_diff": err, "tokens_equal": same}
    failing["whisper-base smoke"] = [] if same and err <= SMOKE_CARD_CPU_TOL else [
        "smoke_card_vs_cpu"]
    torch.cuda.empty_cache()

    # (b) qwen2-vl-7b
    model, params = qwen_model()
    cfg = model.cfg
    print(f"mrope: {cfg.name} full width ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads} "
          f"x {cfg.d_head}, sections {cfg.mrope_sections}, QKV biases N(0, "
          f"{QWEN_BIAS_STD})), bf16 seeded weights, softmax int_pallas ({card})", flush=True)
    batch, prompt_len, max_new = 4, 512, 32
    prompts = SyntheticCorpus(cfg.vocab, seed=1234).sample(batch, prompt_len,
                                                           seed=777)[:, :prompt_len]
    ladder = np.broadcast_to(np.arange(prompt_len, dtype=np.int32)[None, None],
                             (3, batch, prompt_len)).copy()
    gen, res = graphed_generate("qwen2-vl-7b generate", model, params, prompts, max_new,
                                rounds=2, eager_mode=False, extra={"positions": ladder})
    plain = Engine(Model(cfg.with_softmax(SoftmaxSpec("int"))), params, max_new=max_new)
    res_int = plain.generate(prompts, mode="fused", extra_inputs={"positions": ladder})
    gen["int_vs_int_pallas"] = (np.array_equal(res_int.tokens, res.tokens)
                                and torch.equal(res_int.logits, res.logits))
    print(f"  qwen2-vl-7b generate, int_pallas vs int (plain Alg. 1) on the card: tokens and "
          f"last logits bitwise equal {gen['int_vs_int_pallas']}", flush=True)
    failing["qwen2-vl-7b generate"] = [] if gen["int_vs_int_pallas"] else ["int_vs_int_pallas"]
    out["qwen2-vl-7b generate"] = gen
    del plain, res, res_int
    reqs = qwen_trace(cfg.vocab)
    out["qwen2-vl-7b serve"] = serve_phase(
        "qwen2-vl-7b", reqs, ServeOptions(**QWEN_OPTIONS), fused=paged_ops.paged_attention_rows,
        eager_n=1, logit_tol=QWEN_LOGIT_TOL, logit_rms_tol=QWEN_LOGIT_RMS_TOL,
        aligned_tol=QWEN_ALIGNED_TOL, aligned_rms_tol=QWEN_ALIGNED_RMS_TOL,
        max_new=max(r.max_new for r in reqs), model=model, params=params, control=True)
    del model, params
    torch.cuda.empty_cache()
    ds = out["qwen2-vl-7b distinct streams"] = qwen_distinct_streams()
    failing["qwen2-vl-7b distinct streams"] = ds["failing_checks"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 18 in {out['seconds']:.1f} s ({card})", flush=True)
    check(not any(failing.values()), f"phase 18: failing checks {failing}")
    return out


def _commit_keeps_last(commit_staged):
    """A rollback that leaves the block's last rejected position uncleared."""
    def commit(staged, n_accept, cache_pos, t, **kw):
        return commit_staged(staged, n_accept, cache_pos, t - 1, **kw)
    return commit


def _mask_sees_next(verify_mask):
    """A verify mask under which query i also sees position i + 1."""
    def mask(l_max, q_pos, window=0):
        return verify_mask(l_max, q_pos + 1, window)
    return mask


# Known faults of the verify step and its rollback, patched into the port
# for a run: (module, attribute, wrapper of the original).
PHASE14_FAULTS = {
    "commit_staged leaves the last rejected position uncleared": (
        "repro_torch.models.kv_cache", "commit_staged", _commit_keeps_last),
    "verify_mask lets query i see position i + 1": (
        "repro_torch.models.attention", "verify_mask", _mask_sees_next),
}


def phase14_fault_control():
    """Phase 14's checks against known faults of the verify step: the first
    SPEC_SUBSET requests of phase 6's trace served speculatively op by op
    through the gather path (kernel="jnp": the path that reads
    ``verify_mask``) cleanly and once per fault in PHASE14_FAULTS (a fresh
    engine each), each run read by the rollback check, its teacher-forced
    and step-aligned logits and its greedy tokens against the plain serve,
    with phase 6's limits. Fails if a clean run fails a check or a fault
    passes them all; prints which checks catch each."""
    import dataclasses
    import importlib

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    model = Model(get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"),
                             n_layers=OLMO_CUT_LAYERS))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    reqs = shared_prefix_trace(32, model.cfg.vocab, **SERVE_TRACE)[:SPEC_SUBSET]
    plain_opts = ServeOptions(**{**SERVE_OPTIONS, "kernel": "jnp", "report_cost": False})
    spec = dataclasses.replace(plain_opts, speculative=True, draft="ngram", draft_k=SPEC_K)
    rec_p = _LogitRecorder()
    plain, _, plain_rows, _, _ = counted_serve(Engine(model, params, max_new=64, sampler=rec_p),
                                               reqs, plain_opts, rec_p)
    results = []
    for fault in [None] + list(PHASE14_FAULTS):
        label = fault or "clean"
        saved = None
        if fault is not None:
            mod, attr, wrap = PHASE14_FAULTS[fault]
            mod = importlib.import_module(mod)
            saved = getattr(mod, attr)
            setattr(mod, attr, wrap(saved))
        try:
            eng = op_by_op(Engine(model, params, max_new=64))
            rec = SpecRecorder(eng, rollback=True)
            rep = eng.serve(reqs, spec)
        finally:
            if saved is not None:
                setattr(mod, attr, saved)
        rows = rec.trimmed(reqs)
        tf = teacher_forced(f"{label}, phase 14", model, params, reqs,
                            [r.tokens for r in rep.results], rows, CUT_LOGIT_TOL,
                            CUT_LOGIT_RMS_TOL)
        al = aligned_logits(f"{label}, phase 14 vs plain", reqs, rep.results, plain.results,
                            rows, plain_rows)
        divs = [first_divergence(f"{label} vs plain, request {a.rid}", a.tokens, b.tokens,
                                 a.prompt_len, model, params)
                for a, b in zip(rep.results, plain.results)]
        divs = [d for d in divs if d is not None]
        caught = {"rollback": rec.rollback["nonzero"] > 0,
                  "logit_max": max(tf["first_step_max"], tf["decode_max"]) > CUT_LOGIT_TOL,
                  "logit_rms": tf["rms"] > CUT_LOGIT_RMS_TOL,
                  "tokens": any(not d["near_tie"] for d in divs),
                  "aligned_max": al["max"] > CUT_ALIGNED_TOL,
                  "aligned_rms": al["rms"] > CUT_ALIGNED_RMS_TOL}
        results.append({"run": label, "rounds": rep.steps, "rollback": rec.rollback,
                        "diverged": len(divs), "caught_by": [k for k, v in caught.items() if v]})
        print(f"  phase 14, {label}: {rep.steps} rounds, rollback {rec.rollback}, {len(divs)} "
              f"of {len(reqs)} requests diverge from the plain serve; caught by "
              f"{results[-1]['caught_by'] or 'nothing'}", flush=True)
    check(not results[0]["caught_by"], f"a clean phase-14 run fails a check: {results[0]}")
    check(all(r["caught_by"] for r in results[1:]),
          f"a phase-14 fault passes every check: {results[1:]}")
    return results


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
            # a fresh engine: its decode-step graph is captured with the fault
            rep = Engine(model, params, max_new=32, sampler=rec).serve(
                reqs, dataclasses.replace(opts, kernel="jnp"))
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
    model = Model(get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"),
                             n_layers=OLMO_CUT_LAYERS))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=64, sampler=rec)
    plain, _, plain_rows, _, _ = counted_serve(eng, reqs, plain_opts, rec)
    t_plain, _, t_plain_rows, _, _ = counted_serve(
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
            rep, _, rows, _, _ = counted_serve(eng, reqs, opts, rec)
            held = list(victims)
            _, failed = phase13_logits(f"{label}, phase 13 trace", model, params, reqs, rep,
                                       rows, plain, plain_rows)
            caught.update({f"{k} (trace)": v for k, v in failed.items()})
            victims.clear()
            rep_t, _, rows_t, _, _ = counted_serve(eng, targeted, t_opts, rec)
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


def _recurrent_only(tree):
    """The recurrent nodes of a staged tree (those with a "state" or "pos"
    leaf), the positional ones left out."""
    if "state" in tree or "pos" in tree:
        return tree
    out = {k: _recurrent_only(v) for k, v in tree.items() if isinstance(v, dict)}
    return {k: v for k, v in out.items() if v}


def _select_one_late(commit_staged):
    """A rollback that restores each recurrent snapshot one token past the
    accepted depth (the positional leaves cleared as they should be)."""
    def commit(staged, n_accept, cache_pos, t, into=None):
        out = commit_staged(staged, n_accept, cache_pos, t, into=into)
        late = torch.clamp(n_accept + 1, max=t - 1)
        rec = _recurrent_only(staged)
        if rec:
            commit_staged(rec, late, cache_pos, t, into=into)
        return out
    return commit


def _ring_write_one_late(ring_write):
    """A ring decode that writes position p's K, V and position into slot
    (p + 1) % W instead of p % W."""
    def write(cache, k_new, v_new, cache_pos):
        b, w = cache["pos"].shape
        if isinstance(cache_pos, int):
            cache_pos = torch.tensor(cache_pos, device=cache["pos"].device)
        pos = cache_pos.to(torch.long).reshape(-1).expand(b)
        idx = torch.arange(b, device=pos.device) * w + torch.remainder(pos + 1, w)
        for name, new in (("k", k_new), ("v", v_new)):
            leaf = cache[name]
            leaf.view((b * w,) + tuple(leaf.shape[2:])).index_copy_(
                0, idx, new[:, 0].to(leaf.dtype))
        cache["pos"].view(b * w).index_copy_(0, idx, pos.to(cache["pos"].dtype))
    return write


def _stripe_leaves(cache):
    from repro_torch.launch import roofline as rl
    from repro_torch.models import kv_cache

    pools = [id(v) for node in kv_cache._paged_nodes(cache) for v in node.values()]
    return [v for _, v in rl.named_leaves(cache) if id(v) not in pools]


def _stripe_to_other_slot(swap_write):
    """A resume that restores the slot-resident stripes into the next slot
    (the blocks and the table row where they belong): that slot's stripes
    are overwritten and the resumed slot keeps what it held."""
    def write(cache, payload, slot, ids, table_row):
        stripes = _stripe_leaves(cache)
        held = [v[:, slot].clone() for v in stripes]
        out = swap_write(cache, payload, slot, ids, table_row)
        other = (slot + 1) % stripes[0].shape[1]
        for v, h in zip(stripes, held):
            v[:, other] = v[:, slot]
            v[:, slot] = h
        return out
    return write


def _d_skip_dropped(ssm_decode):
    """A decode step without the SSM's D skip (y = C . state alone); the
    forward pass keeps it, so only REC_GEN_TOL can see it."""
    def decode(p, x_in, cache, cfg, ctx):
        return ssm_decode(dict(p, D=torch.zeros_like(p["D"])), x_in, cache, cfg, ctx)
    return decode


# Known faults of the recurrent paths, patched into the port for a run:
# (module or modules, attribute, wrapper of the original, the runs that
# read it).
REC_FAULTS = {
    "the SSM decode step drops its D skip": (
        ("repro_torch.models.transformer", "repro_torch.models.hybrid"), "ssm_decode",
        _d_skip_dropped, "generate"),
    "commit_staged selects the recurrent snapshot one step late": (
        "repro_torch.models.kv_cache", "commit_staged", _select_one_late, "spec"),
    "attn_decode_ring writes slot (pos + 1) % W": (
        "repro_torch.models.attention", "_ring_write", _ring_write_one_late, "ring"),
    "swap_write restores a stripe into another slot": (
        "repro_torch.models.kv_cache", "swap_write", _stripe_to_other_slot, "swap"),
}


def _rec_serve_logits(model, params, reqs):
    """(c)'s teacher-forced check alone: the served logits of the pallas
    serve against the forward pass, the checks that fail."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    lr = _LogitRecorder()
    rep = Engine(model, params, max_new=max(r.max_new for r in reqs), sampler=lr).serve(
        reqs, ServeOptions(**{**SERVE_OPTIONS, "report_cost": False}))
    tf = teacher_forced(f"{model.cfg.name} serve kernel=pallas", model, params, reqs,
                        [r.tokens for r in rep.results], lr.rows, HYMBA_LOGIT_TOL,
                        HYMBA_LOGIT_RMS_TOL)
    return [k for k, v in (("serve_logit_max", max(tf["first_step_max"], tf["decode_max"])
                            > HYMBA_LOGIT_TOL),
                           ("serve_logit_rms", tf["rms"] > HYMBA_LOGIT_RMS_TOL)) if v]


def phase17_fault_control():
    """Phase 17's checks against the four faults of REC_FAULTS, each run
    with the fault patched in: both models' generate against the forward
    pass (``recurrent_generate``; the D skip, which only REC_GEN_TOL can
    catch, so it must be caught there), the speculative serves of both models
    (``recurrent_spec``: equal to the plain serve, launches, widths), hymba's
    generate (``recurrent_generate``: the logits against the forward pass,
    the ring positions, graph == op by op, int == int_pallas) and its
    serve's teacher-forced logits, and both models' chunked, preempting
    serves (``recurrent_chunked_preempt``: the swap round trip, equal to
    the plain serve). Prints which checks catch each."""
    import importlib

    from repro_torch.data.synthetic import SyntheticCorpus

    results = {}
    for arch in REC_ARCHS:
        model, params = rec_model(arch)
        cfg = model.cfg
        kernel = "pallas" if cfg.uses_attention else "jnp"
        reqs, creqs = rec_trace(cfg.vocab), rec_trace(cfg.vocab, classes=True)
        plain, plain_rows = rec_plain(model, params, reqs, kernel)
        p = REC_PROMPT[arch]
        prompts = SyntheticCorpus(cfg.vocab, seed=1234).sample(REC_BATCH, p, seed=777)[:, :p]
        for fault, (mod, attr, wrap, run) in REC_FAULTS.items():
            if run == "ring" and not cfg.uses_attention:
                continue
            mods = [importlib.import_module(m) for m in
                    (mod if isinstance(mod, tuple) else (mod,))]
            sound = [getattr(m, attr) for m in mods]
            for m, f in zip(mods, sound):
                setattr(m, attr, wrap(f))
            try:
                if run == "generate":
                    caught = recurrent_generate(model, params, prompts)["failing_checks"]
                    check({"logit_max", "logit_rms"} & set(caught),
                          f"phase 17 fault control: {arch}, {fault} passes REC_GEN_TOL")
                elif run == "spec":
                    caught = recurrent_spec(model, params, reqs, kernel, plain,
                                            plain_rows)["failing_checks"]
                elif run == "ring":
                    caught = recurrent_generate(model, params, prompts)["failing_checks"]
                    caught += _rec_serve_logits(model, params, reqs)
                else:
                    caught = recurrent_chunked_preempt(model, params, creqs, kernel, plain,
                                                       plain_rows)["failing_checks"]
            finally:
                for m, f in zip(mods, sound):
                    setattr(m, attr, f)
            results[f"{arch}, {fault}"] = caught
            print(f"phase 17, {arch}, {fault}: caught by {caught}", flush=True)
            check(caught, f"phase 17 fault control: {arch}, {fault} caught by no check")
        del model, params, plain, plain_rows
        torch.cuda.empty_cache()
    return results


def _sections_rotated_on_card(apply_mrope):
    """M-RoPE's sections rotated by one stream on the card; the CPU side of
    the distinct-streams check keeps the sound split."""
    def rotated(x, positions, theta, sections):
        if x.is_cuda:
            sections = tuple(sections[1:]) + tuple(sections[:1])
        return apply_mrope(x, positions, theta, sections)
    return rotated


def _cross_of_next_slot(dec_block_decode):
    """A decoder step whose slot b reads slot b - 1's cross K/V (a batch of
    one reads its own)."""
    def shifted(p, x, cache, cache_pos, cfg, ctx, positions):
        cross = {k: torch.roll(v, 1, dims=0) for k, v in cache["cross"].items()}
        y, _ = dec_block_decode(p, x, {"self": cache["self"], "cross": cross}, cache_pos, cfg,
                                ctx, positions)
        return y, cache
    return shifted


@contextlib.contextmanager
def _positions_outside_buffers():
    """An M-RoPE serve step whose position streams come from a tensor the
    host makes for each step, not from the step's input buffer: op by op
    each step reads its own, a CUDA-graph replay reads the tensor the
    capture read (kept alive, so its bytes stay the capture step's)."""
    from repro_torch.models.model import Model
    from repro_torch.serving import engine as em

    made = []
    sound_step, sound_decode = Model.decode_step, em.Engine._serve_decode

    def decode(self, st, host_inputs, generators):
        made.append(torch.as_tensor(host_inputs[1].copy(), device="cuda"))
        return sound_decode(self, st, host_inputs, generators)

    def step(self, p, cache, batch, cache_pos):
        if "positions" in batch:
            batch = dict(batch, positions=made[-1].to(torch.int32)[None, :, None].expand(3, -1, 1))
        return sound_step(self, p, cache, batch, cache_pos)

    Model.decode_step, em.Engine._serve_decode = step, decode
    try:
        yield
    finally:
        Model.decode_step, em.Engine._serve_decode = sound_step, sound_decode


def phase18_fault_control():
    """Phase 18's checks against three faults, each patched in: M-RoPE's
    sections rotated on the card (the distinct-streams check; the same
    comparison on text-only streams, for information, cannot see it),
    each whisper slot decoding with its neighbour's cross K/V
    (``whisper_serve``'s checks), and the M-RoPE serve step's positions
    outside its input buffer (graph == op by op on qwen2-vl-7b's first 2
    requests, which start at different offsets). Prints which checks
    catch each."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.options import ServeOptions

    results = {}

    def report(fault, caught):
        results[fault] = caught
        print(f"phase 18, {fault}: caught by {caught}", flush=True)
        check(caught, f"phase 18 fault control: {fault} caught by no check")

    sound = attention.apply_mrope
    attention.apply_mrope = _sections_rotated_on_card(sound)
    try:
        caught = qwen_distinct_streams()["failing_checks"]
        err, same = smoke_card_vs_cpu("qwen2-vl-7b", lambda cfg: {
            "tokens": np.random.default_rng(7).integers(0, cfg.vocab, (2, 24)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(24, dtype=np.int32), (3, 2, 24)).copy()})
    finally:
        attention.apply_mrope = sound
    print(f"  (information) the same card-vs-CPU comparison on text-only streams under the "
          f"fault: tokens equal {same}, logits max |diff| {err:.3e}", flush=True)
    report("M-RoPE sections rotated on the card", caught)

    cfg = get_config("whisper-base", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    sound = tfm.dec_block_decode
    tfm.dec_block_decode = _cross_of_next_slot(sound)
    try:
        caught = whisper_serve(model, params, whisper_trace(cfg))["failing_checks"]
    finally:
        tfm.dec_block_decode = sound
    report("each whisper slot decodes with its neighbour's cross K/V", caught)
    del model, params
    torch.cuda.empty_cache()

    model, params = qwen_model()
    reqs = qwen_trace(model.cfg.vocab)[:2]
    opts = ServeOptions(**dict(QWEN_OPTIONS, report_cost=False))
    runs = []
    with _positions_outside_buffers():
        for graphed in (True, False):
            lr = _LogitRecorder()
            eng = Engine(model, params, max_new=max(r.max_new for r in reqs), sampler=lr)
            if not graphed:
                op_by_op(eng)
            rep, _, rows, _, _ = counted_serve(eng, reqs, opts, lr)
            runs.append((rep, rows, eng))
    out = serve_graph_vs_op(f"qwen2-vl-7b serve, first 2 requests (prompts "
                            f"{[r.prompt_len for r in reqs]}), positions outside the buffer",
                            reqs, *runs, gate=False)
    report("the M-RoPE step's positions outside its input buffer",
           ["graph_vs_op_by_op"] if not all(out.values()) else [])
    del model, params, runs
    torch.cuda.empty_cache()
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


# ----------------------------------------------------------------- phase 19

# Training (item 13): full-width, full-depth olmo-1b from f32 master
# weights, bf16 compute, every layer rematerialised (cfg.remat "full"),
# Alg. 1 at BEST (``int``), the train launcher's AdamW and schedule at
# ``--steps 8 --lr 1e-3`` (cosine over TRAIN_STEPS steps, warmup 1) on one
# SyntheticCorpus batch repeated. At the launcher's default lr 1e-2 the
# full-width loss rose (11.25 -> 13.94 by step 4, 11.58 at step 8 on the
# H100), and so does the reference's: at 1 layer on the CPU both packages
# spike at steps 4-5, and at 1e-3 both fall to 0.03 by step 4 and stay
# there (``python tests/test_torch_training.py``; PERF.md §6, training
# and checkpoints).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 8, 1e-3
# The loss must fall by at least this many nats over the TRAIN_STEPS steps
# on the repeated batch.
TRAIN_LOSS_DROP = 1.0
# The smoke config's train step on the card against the CPU, both in f32
# (no TF32), from the same weights, as tests/test_torch_training.py holds
# the port against the reference: the loss within 1e-5 relative, each
# gradient leaf within 1e-4 in relative L2 norm (cuBLAS and the CPU sum in
# other orders; an Alg.-1 code may move at an ulp), each updated leaf
# within 2.2 lr at most (Adam's first step is sign-like: an entry whose
# gradient is near zero may step the other way) and 2e-5 in mean.
TRAIN_CARD_CPU_LOSS, TRAIN_CARD_CPU_GRAD = 1e-5, 1e-4
TRAIN_CARD_CPU_UPD_LR, TRAIN_CARD_CPU_UPD_MEAN = 2.2, 2e-5
# microbatches=2 against 1 on the card: the two halves' gradients averaged
# against the whole batch's, 1e-5 in relative L2 norm per leaf; the loss
# 1e-6 relative.
TRAIN_MICRO_GRAD, TRAIN_MICRO_LOSS = 1e-5, 1e-6
# The serve launcher's run: olmo-1b at full width, warm-trained
# TRAIN_WARM_STEPS steps against fp, then served through K1 and K2.
TRAIN_WARM_STEPS, TRAIN_WARM_REQUESTS = 8, 4
TRAIN_WARM_ARGS = ["--arch", "olmo-1b", "--no-smoke", "--softmax", "int_pallas",
                   "--warm-steps", str(TRAIN_WARM_STEPS), "--continuous", "--paged",
                   "--kernel", "pallas", "--requests", str(TRAIN_WARM_REQUESTS),
                   "--max-new", "8"]


def _qk_leaves(tree):
    """(path, tensor) of every query / key projection weight of a params
    (or gradient) tree."""
    from repro_torch.launch import roofline as rl

    return [(k, v) for k, v in rl.named_leaves(tree) if k.endswith(("wq/w", "wk/w"))]


def _train_leaves(state):
    """(path, tensor) of every leaf of a TrainState: params, moments, step."""
    from repro_torch.launch import roofline as rl

    return ([("params/" + k, v) for k, v in rl.named_leaves(state.params)]
            + [("opt/m/" + k, v) for k, v in rl.named_leaves(state.opt.m)]
            + [("opt/v/" + k, v) for k, v in rl.named_leaves(state.opt.v)]
            + [("opt/step", state.opt.step)])


def train_full_width():
    """(a): TRAIN_STEPS steps of full-width olmo-1b on one repeated batch.
    Gates: the loss finite every step and falling by TRAIN_LOSS_DROP; the
    final params' gradients under ``int`` exactly zero on every query and
    key projection and their global norm finite and > 0; under ``int_ste``
    (the STE backward) those leaves non-zero. Times: ms a step (median of
    the steps after the first, host clock around synchronized steps),
    tokens/s, the AdamW update alone, peak memory."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamW, cosine_schedule, global_norm
    from repro_torch.training.step import init_state, make_grad_fn, make_train_step, to_device

    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int"))
    check(cfg.remat == "full", f"olmo-1b remat {cfg.remat!r}")
    model = Model(cfg)                                   # bf16 compute on the card
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, max(TRAIN_STEPS // 10, 1), TRAIN_STEPS))
    step = make_train_step(model, opt)
    batch = to_device(SyntheticCorpus(cfg.vocab, seed=1234).batch(TRAIN_BATCH, TRAIN_SEQ,
                                                                  seed=0), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, opt, torch.Generator("cuda").manual_seed(0))
    masters = {str(v.dtype) for _, v in rl.named_leaves(state.params)}
    losses, gnorms, walls = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(walls[1:])
    print(f"  training {cfg.name} full width and depth ({cfg.param_count() / 1e9:.3f} B "
          f"parameters, {cfg.n_layers} layers, d_model {cfg.d_model}), master weights "
          f"{sorted(masters)}, compute bf16, remat {cfg.remat}, softmax int, AdamW lr "
          f"{TRAIN_LR:g} cosine over {TRAIN_STEPS} steps, batch {TRAIN_BATCH} x {TRAIN_SEQ} repeated: "
          f"losses {[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 4) for v in gnorms]}", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"training: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] <= losses[0] - TRAIN_LOSS_DROP,
          f"training: loss {losses[0]} -> {losses[-1]}, expected a drop of "
          f">= {TRAIN_LOSS_DROP}")
    check(masters == {"torch.float32"}, f"training: master weights {masters}")

    # the gradients of the final params: zero on q / k under int, not under the STE
    grads, _ = make_grad_fn(model)(state.params, batch)
    qk = _qk_leaves(grads)
    gn = float(global_norm(grads))
    zero_qk = all(not bool(v.any()) for _, v in qk)
    del grads
    ste = Model(cfg.with_softmax(SoftmaxSpec("int_ste")))
    grads, _ = make_grad_fn(ste)(state.params, batch)
    ste_qk = {k: float(v.abs().max()) for k, v in _qk_leaves(grads)}
    del grads
    print(f"  training gradients: under int every query / key projection leaf exactly zero "
          f"{zero_qk} ({[k for k, _ in qk]}), global norm {gn:.6g}; under int_ste their "
          f"largest |g| {ste_qk}", flush=True)
    check(len(qk) == 2 and zero_qk, "training: int gives a query / key projection a gradient")
    check(np.isfinite(gn) and gn > 0, f"training: grad norm {gn}")
    check(all(v > 0 for v in ste_qk.values()), f"training: int_ste q / k gradients {ste_qk}")

    # the AdamW update alone, on gradients of the step's size and layout
    grads = state.opt.m
    upd = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = opt.update(grads, state.opt, state.params)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t0)
        del new
    update_ms = statistics.median(upd) * 1e3
    # 6 N T (roofline.train_6nt): forward and backward products of the N
    # weights a token meets, at the bf16 peak; the recomputed forward of
    # remat "full" adds 2 N T on top
    flops, flops_ms = rl.train_6nt(state.params, tokens)
    rec = {"arch": cfg.name, "params_b": cfg.param_count() / 1e9, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses, "grad_norms": gnorms,
           "step_walls_s": walls, "ms_per_step": step_s * 1e3, "tok_s": tokens / step_s,
           "optimizer_update_ms": update_ms, "peak_gib": peak,
           "model_flops_per_step": flops, "flops_bound_ms": flops_ms,
           "int_qk_grads_zero": zero_qk, "grad_norm_final": gn, "int_ste_qk_max": ste_qk,
           "state_bytes": rl.tree_bytes(state), "remat": cfg.remat}
    print(f"  training: {step_s * 1e3:.1f} ms a step (median of steps 2-{TRAIN_STEPS}; "
          f"first {walls[0] * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s, AdamW update "
          f"alone {update_ms:.2f} ms (median of 3), peak device memory {peak:.2f} GiB; 6 N T = "
          f"{flops:.3e} FLOPs a step, {rec['flops_bound_ms']:.2f} ms at the bf16 peak "
          f"({rl.PEAK_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{rec['flops_bound_ms'] / (step_s * 1e3) * 100:.1f} % of it "
          f"({card_line()})", flush=True)
    del state, grads, model, ste
    torch.cuda.empty_cache()
    return rec


def train_card_vs_cpu():
    """(b): the smoke config's train step on the card against the CPU, f32,
    from the same weights: loss, every gradient leaf and every updated leaf
    within the TRAIN_CARD_CPU_* bounds; microbatches=2 against 1 on the card
    within TRAIN_MICRO_*; the compression's payload and residual adding up
    to the gradients and the old residual bitwise on the card."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.training.grad_compression import compress, decompress, init_error_feedback
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.step import TrainState, make_grad_fn, make_train_step

    scfg = smoke_config("olmo-1b", softmax=SoftmaxSpec("int"))
    models = {"cpu": Model(scfg, dtype=torch.float32, device="cpu"),
              "cuda": Model(scfg, dtype=torch.float32)}
    params = models["cpu"].init(torch.Generator("cpu").manual_seed(0), dtype=torch.float32)
    params = {"cpu": params, "cuda": _tree_to(params, "cuda")}
    batch = SyntheticCorpus(scfg.vocab, seed=1234).batch(4, 64, seed=1)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS))
    lr = float(opt.lr(torch.tensor(1, dtype=torch.int32)))
    grads, mets, new = {}, {}, {}
    for dev, m in models.items():
        grads[dev], mets[dev] = make_grad_fn(m)(params[dev], batch)
        p = params[dev]
        new[dev], _ = make_train_step(m, opt)(TrainState(p, opt.init(p), None), batch)
    loss_rel = abs(float(mets["cuda"]["loss"]) / float(mets["cpu"]["loss"]) - 1)
    g_rel, upd = {}, {}
    for (k, c), (_, g) in zip(rl.named_leaves(grads["cpu"]), rl.named_leaves(grads["cuda"])):
        g = g.cpu()
        g_rel[k] = (0.0 if not c.any() and not g.any()
                    else float(torch.linalg.norm(g - c) / torch.linalg.norm(c)))
    for (k, c), (_, g) in zip(rl.named_leaves(new["cpu"].params),
                              rl.named_leaves(new["cuda"].params)):
        d = (g.cpu() - c).abs()
        upd[k] = (float(d.max()), float(d.mean()))
    worst_g = max(g_rel.items(), key=lambda kv: kv[1])
    worst_u = max(upd.items(), key=lambda kv: kv[1][0])
    print(f"  training, smoke {scfg.name} f32 card vs CPU, one step: loss {float(mets['cpu']['loss']):.7f} "
          f"(card rel diff {loss_rel:.2e}, bound {TRAIN_CARD_CPU_LOSS}); worst gradient leaf "
          f"{worst_g[0]} {worst_g[1]:.2e} in relative norm (bound {TRAIN_CARD_CPU_GRAD}); worst "
          f"updated leaf {worst_u[0]} max {worst_u[1][0]:.2e} (bound {TRAIN_CARD_CPU_UPD_LR} x lr "
          f"{lr:.0e}), mean {max(v[1] for v in upd.values()):.2e} (bound "
          f"{TRAIN_CARD_CPU_UPD_MEAN})", flush=True)
    check(loss_rel <= TRAIN_CARD_CPU_LOSS, f"training card vs CPU: loss {loss_rel}")
    check(worst_g[1] <= TRAIN_CARD_CPU_GRAD, f"training card vs CPU: gradient {worst_g}")
    check(all(mx <= TRAIN_CARD_CPU_UPD_LR * lr and mn <= TRAIN_CARD_CPU_UPD_MEAN
              for mx, mn in upd.values()), f"training card vs CPU: updates {upd}")

    g2, m2 = make_grad_fn(models["cuda"], microbatches=2)(params["cuda"], batch)
    micro = max(float(torch.linalg.norm(b - a) / max(torch.linalg.norm(a), 1e-30))
                for (_, a), (_, b) in zip(rl.named_leaves(grads["cuda"]), rl.named_leaves(g2)))
    micro_loss = abs(float(m2["loss"]) / float(mets["cuda"]["loss"]) - 1)
    ef = compress(grads["cuda"], init_error_feedback(grads["cuda"]))[1]   # a residual
    payload, new_e = compress(g2, ef)
    sums = all(torch.equal(p + e, g + r) for (_, p), (_, e), (_, g), (_, r) in zip(
        rl.named_leaves(decompress(payload)), rl.named_leaves(new_e), rl.named_leaves(g2),
        rl.named_leaves(ef)))
    print(f"  training on the card: microbatches=2 against 1, worst gradient leaf "
          f"{micro:.2e} in relative norm (bound {TRAIN_MICRO_GRAD}), loss {micro_loss:.2e} "
          f"(bound {TRAIN_MICRO_LOSS}); grad_compress: payload.float() + new residual == "
          f"g + residual bitwise on every leaf: {sums}", flush=True)
    check(micro <= TRAIN_MICRO_GRAD and micro_loss <= TRAIN_MICRO_LOSS,
          f"training: microbatches {micro}, {micro_loss}")
    check(sums, "training: compressed payload + residual != gradients + residual")
    return {"loss_rel": loss_rel, "worst_grad_rel": worst_g, "updates": upd,
            "micro_grad_rel": micro, "micro_loss_rel": micro_loss, "compress_bitwise": sums}


def train_checkpoint_round_trip():
    """(c): olmo-1b at full width and 1 layer, 2 steps, saved into a
    temporary directory under build/ (removed after); every restored leaf
    (params, m, v, step) bitwise the saved one, and the step after the
    restore bitwise the step from the live state, both under
    torch.use_deterministic_algorithms (the embedding's gather accumulates
    its gradient by index). Prints the bytes written and the seconds."""
    import tempfile
    import warnings

    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.step import init_state, make_train_step, to_device

    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int"), n_layers=1)
    model = Model(cfg)
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS))
    step = make_train_step(model, opt)
    batch = to_device(SyntheticCorpus(cfg.vocab, seed=1234).batch(TRAIN_BATCH, TRAIN_SEQ,
                                                                  seed=2), "cuda")
    was = torch.are_deterministic_algorithms_enabled()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with warnings.catch_warnings():
        # cuBLAS has no flagged deterministic mode without a workspace setting
        # made before the process starts; on one stream it repeats its bits
        warnings.filterwarnings("ignore", message=".*Deterministic behavior.*")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            state = init_state(model, opt, torch.Generator("cuda").manual_seed(0))
            for _ in range(2):
                state, _ = step(state, batch)
            with tempfile.TemporaryDirectory(prefix="ckpt_", dir=BUILD_DIR) as d:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = ckpt.save(d, 2, state)
                save_s = time.perf_counter() - t0
                nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
                template = init_state(model, opt, torch.Generator("cuda").manual_seed(1))
                t0 = time.perf_counter()
                got, at, _ = ckpt.restore(d, template)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                del template
            same = {k: bool(torch.equal(a, b)) for (k, a), (_, b) in
                    zip(_train_leaves(state), _train_leaves(got))}
            live, _ = step(state, batch)
            del state
            back, _ = step(got, batch)
            resumed = {k: bool(torch.equal(a, b)) for (k, a), (_, b) in
                       zip(_train_leaves(live), _train_leaves(back))}
        finally:
            torch.use_deterministic_algorithms(was)
    print(f"  checkpoint round trip, {cfg.name} full width, {cfg.n_layers} layer, after 2 steps: "
          f"{nbytes} B written in {save_s:.2f} s, restored in {restore_s:.2f} s; every leaf "
          f"bitwise (params, m, v, step) {all(same.values())} over {len(same)} leaves; the "
          f"step after the restore == the live state's step, bitwise: {all(resumed.values())} "
          f"({card_line()})", flush=True)
    check(at == 2 and all(same.values()), f"checkpoint: restored leaves differ {same}")
    check(all(resumed.values()), f"checkpoint: the resumed step differs {resumed}")
    del live, back, got, model
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s, "leaves": len(same),
            "bitwise": all(same.values()), "resumed_bitwise": all(resumed.values())}


def train_warm_serve():
    """(d): ``python -m repro_torch.launch.serve`` in-process with
    TRAIN_WARM_ARGS: full-width olmo-1b warm-trained against fp, then served
    through K1 (prefills) and K2 (paged decode) twice (the launcher's
    warm-up serve and its reported one). The launch counters are zeroed
    just before and read just after: K1 n_layers a prefill; K2 n_layers a
    decode step, the wrappers counting the steps run op by op (each graph's
    warm-up step) and each captured graph's replays adding the kernel calls
    of one replay in its device trace (``path_launches``, which gates them
    at n_layers K2 and nothing else); no other kernel. No leaked blocks,
    finite tokens in range."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    cfg = get_config("olmo-1b")
    reps, engines, orig = [], [], Engine.serve

    def recording(self, *args, **kw):
        rep = orig(self, *args, **kw)
        reps.append(rep)
        engines.append(self)
        return rep

    Engine.serve = recording
    zero_counters()
    t0 = time.perf_counter()
    try:
        rep = serve.main(TRAIN_WARM_ARGS)
    finally:
        Engine.serve = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = read_counters()
    n_layers = cfg.n_layers
    steps = sum(r.steps for r in reps)
    replays = sum(r.step_replays for r in reps)
    prefills = sum(len(r.results) for r in reps)
    want = {k: 0 for k in counted}
    want["K1"] = n_layers * prefills
    want["K2"] = n_layers * (steps - replays)
    print(f"  serve launcher {' '.join(TRAIN_WARM_ARGS)}: {wall:.1f} s (warm training, model "
          f"build and both serves); serves {len(reps)}, decode steps {steps} ({replays} graph "
          f"replays), prefills {prefills}; the wrappers' launches {counted} (expected {want}: "
          f"K1 {n_layers} a prefill, K2 {n_layers} a step run op by op); leaked blocks "
          f"{rep.leaked_blocks}", flush=True)
    check(len(reps) == 2 and all(len(r.results) == TRAIN_WARM_REQUESTS for r in reps)
          and all(e is engines[0] for e in engines), f"warm serve: {len(reps)} serves")
    check(counted == want and counted["K1"] > 0 and counted["K2"] > 0,
          f"warm serve: launches {counted}, expected {want}")
    # the engine is the launcher's own, so every replay of its graphs was
    # made in this run
    replayed = replay_counts(engines[0])
    check(sum(replayed.values()) == replays and replays > 0,
          f"warm serve: graph replays {replayed}, the reports count {replays}")
    label = "warm-trained serve olmo-1b"
    traces = replay_trace(label, replayed_graphs(engines[0], replayed))
    launches = path_launches(label, counted, replayed, traces,
                             serve_launches(cfg, "K2", False, counted, 0, 1))
    check(launches == serve_launches(cfg, "K2", False, launches, prefills, steps),
          f"warm serve: launches {launches} with the replays, expected K1 {n_layers} a "
          f"prefill and K2 {n_layers} a step")
    check(rep.leaked_blocks == 0, f"warm serve: {rep.leaked_blocks} leaked blocks")
    check(all(all(0 <= t < cfg.vocab for t in r.tokens) for r in rep.results),
          "warm serve: tokens out of range")
    return {"wall_s": wall, "serves": len(reps), "steps": steps, "replays": replays,
            "prefills": prefills, "counted": counted, "launches": launches}


def phase19_training():
    """Training (item 13): (a) full-width olmo-1b training steps, (b) the
    smoke step card vs CPU, (c) the checkpoint round trip, (d) the serve
    launcher with --warm-steps. Seconds of each printed."""
    card = card_line()
    t_phase = time.perf_counter()
    out = {}
    for name, fn in (("train", train_full_width), ("card vs cpu", train_card_vs_cpu),
                     ("checkpoint", train_checkpoint_round_trip),
                     ("warm serve", train_warm_serve)):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"  phase 19 ({name}): {out[name]['seconds']:.1f} s", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 19 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


# ----------------------------------------------------------------- phase 20

# Tensor-parallel serving (ROADMAP item 14) and qwen2.5-32b, the last
# reference architecture. (a) serves qwen2.5-32b at full width and full
# depth (64 layers, 32.76 B parameters, 61.0 GiB of bf16 weights) on one
# card, single-device, on phase 6's trace cut to QWEN32_REQUESTS requests
# with phase 6's options. (b) serves that trace at TP_LAYERS of its layers
# (the same weights, the stack sliced) single-device and over TP_SHARDS
# shards, every shard on cuda:0 (``make_serving_mesh(n, devices=[dev] *
# n)``, as the tests put them on the CPU), from the bf16 pool, and at 4
# shards from the int8 pool against the single-device int8 serve. (c)
# serves minicpm3-4b at TP_MLA_LAYERS of its 62 layers over 2 shards on
# phase 8's trace (K4 on the gathered latent pool). The depth of (b) and
# (c) is cut so the phase fits the run's budget; their widths are full. At
# 16 layers phase 20 took 137.6 s against 87.0 s at 8 in one call, every
# gate passing there too (max 0.08594, RMS 0.0142, every divergence at a
# near tie: ``probes/tp_readings.py``); the 51 s would put the whole run
# past its 1100 s target on the slowest hosts seen. Since PR 30 (b) and
# (c) serve the first TP_REQUESTS requests of their traces (room for phase
# 16's sharded MoE serves, PERF.md §6): every slot of a step runs at the
# step's full rows whatever is live, and K2 / K4 work per slot, so each of
# those requests gets the logits it got among 8, and the limits below,
# read over 8, hold for them.
QWEN32_REQUESTS = 8
TP_REQUESTS = 4
TP_LAYERS = 8
TP_MLA_LAYERS = 8
TP_SHARDS = (2, 4)
# phase 6's options without the AP cost meter (not a phase-20 gate: each of
# a run's engines would meter the 64-layer step and prefills on the meta
# device again)
TP_OPTIONS = dict(SERVE_OPTIONS, report_cost=False)
# A sharded serve against the single-device serve at its depth: bitwise
# (tokens and every step-aligned logit row), or else greedy tokens equal
# but at near ties and the step-aligned logits within these limits (tier
# (b)). On the H100 no sharded serve is bitwise: cuBLAS gives a shard's
# columns of some products other bits than the whole product's (wq at 8
# rows over 2 or 4 shards, gate / up over 4: ``probes/tp_columns.py``,
# PERF.md §6). The limits are 1.3 times the largest sound reading
# (max 0.07812: the bf16 pool at 4 shards and --fault-control's clean run;
# RMS 0.01205: the int8 pool at 4 shards; every divergence at a near tie;
# minicpm3-4b at 2 shards 0.01562 / 0.0001056 with none). The faults of
# --fault-control read 7.062 / 1.406 (heads gathered out of order) and
# 4.297 / 0.5271 (a shard's K2 dropping its last kv-head), each with
# divergences past the near-tie bound.
TP_ALIGNED_TOL = 1.3 * 0.07812
TP_ALIGNED_RMS_TOL = 1.3 * 0.01205


def big_model_params(model, bias_std, seed=0):
    """Seeded bf16 weights on the card for a model whose stacked f32 draws
    would not fit beside its weights (``Model.init`` draws qwen2.5-32b's
    ``gate`` as one 36 GB f32 tensor): each weight matrix drawn one layer at
    a time from N(0, 1/d_in) as the init's, the embedding N(0, 0.02), norms
    ones, the QKV biases N(0, ``bias_std``) (the init's are zero)."""
    from repro_torch.models.model import Model

    meta = Model(model.cfg, device="meta").init()
    g = torch.Generator("cuda").manual_seed(seed)

    def draw(shape, std, dtype):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        out = torch.empty(node.shape, dtype=node.dtype, device="cuda")
        if path[-1] == "scale":
            return out.fill_(1.0)
        if path == ("embed", "w"):
            return out.copy_(draw(out.shape, 0.02, out.dtype))
        if path == ("head", "w"):
            return out.copy_(draw(out.shape, out.shape[0] ** -0.5, out.dtype))
        std = bias_std if path[-1] == "b" else out.shape[1] ** -0.5
        for i in range(out.shape[0]):
            out[i] = draw(out.shape[1:], std, out.dtype)
        return out

    return walk(meta, ())


def _layers_of(params, n):
    """The first ``n`` layers of a dense model's parameters (views)."""
    from repro_torch.models import kv_cache

    out = dict(params)
    out["stack"] = {"layers": kv_cache.tree_map(lambda v: v[:n], params["stack"]["layers"])}
    return out


def _shard_pool_bytes(eng, st, opts, rep, n):
    """Each shard's cache bytes in a serve's step state against
    ``pool_report``'s ``per_device_bytes`` for the serve's geometry."""
    from repro_torch.launch import roofline as rl
    from repro_torch.serving.sharded import pool_report

    caches = st.cache if n > 1 else [st.cache]
    got = [sum(t.numel() * t.element_size() for _, t in rl.named_leaves(c)) for c in caches]
    want = pool_report(st.model.cfg, opts.slots, rep.cache_len, opts.block_size,
                       eng._last_alloc.num_blocks, n)
    return {"per_shard_bytes": got, "per_device_bytes": want["per_device_bytes"],
            "total_bytes": want["total_bytes"], "tokens": eng._last_alloc.num_blocks
            * opts.block_size, "ok": all(b == want["per_device_bytes"] for b in got)}


def tp_serve(label, model, params, reqs, opts, n, name, base=None, timed=True,
             tol=(TP_ALIGNED_TOL, TP_ALIGNED_RMS_TOL), routes=False):
    """One checked serve of ``reqs`` over ``n`` shards on cuda:0 (``n`` 1:
    single-device), graphed: every call of ``name`` (the fused paged
    decode) at (T 1, the unsharded step's group or, for K4, the shard's
    heads), no leaked blocks, each shard's pool bytes ``pool_report``'s,
    one capture; the first request graphed == op by op bitwise (tokens,
    logit rows, every shard's pool bytes); at most MAX_REPLAYED_STEP_OPS
    aten ops a replayed step and ms a step of a warm graphed serve; and
    against ``base`` (the single-device serve's record at this depth):
    tokens and every step-aligned logit row bitwise, or tier (b)
    (``TP_ALIGNED_*``, near ties). ``timed`` False: no timed serve (its
    aten ops and ms a step not read). Returns the record, its engine kept:
    ``tp_finish`` reads its launches from one device trace of every run's
    graph (a profiler session per run costs more than the runs)."""
    import dataclasses

    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import Engine

    cfg = model.cfg
    t_run = time.perf_counter()
    L, int8 = cfg.n_layers, cfg.kv_quant
    if n > 1:
        opts = dataclasses.replace(opts, mesh=make_serving_mesh(
            n, devices=[torch.device("cuda", 0)] * n))
    max_new = max(r.max_new for r in reqs)
    rec = _LogitRecorder()
    eng = Engine(model, params, max_new=max_new, sampler=rec)
    torch.cuda.reset_peak_memory_stats()
    with KernelWidths() as widths:
        rep, counted, rows, first_s, replayed = counted_serve(eng, reqs, opts, rec)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_replay = {k: 0 for k in counted}
    per_replay[name] = n * L
    if int8:
        per_replay["K2 on int8 pools"] = n * L
    want = {k: 0 for k in counted}
    want["K1"] = n * L * len(reqs)
    want[name] = n * L * rep.steps
    if int8:
        want["K2 on int8 pools"] = n * L * rep.steps
    rows_per_call = cfg.n_heads // n if name == "K4" else cfg.n_heads // cfg.n_kv_heads
    w = widths.widths(name)
    (st,) = [eng._decode_states[k] for k in replayed]
    pool = _shard_pool_bytes(eng, st, opts, rep, n)
    out = {"label": label, "shards": n, "layers": L, "kv_pool": "int8" if int8 else "bf16",
           "steps": rep.steps, "expected_launches": want, "kernel_widths": w, "pool": pool,
           "leaked_blocks": rep.leaked_blocks, "first_serve_s": first_s, "peak_gib": peak,
           "cache_len": rep.cache_len, "num_blocks": eng._last_alloc.num_blocks,
           "slots": opts.slots, "block_size": opts.block_size, "pool_bytes": cache_bytes(st),
           "param_bytes": rl.tree_bytes(params) if n == 1 else None,
           "step_keys": rl.live_keys(st.cache, st.buffers[0][1]) if n == 1 else None}
    print(f"{label}: {rep.steps} decode steps, {len(reqs)} requests, cache_len "
          f"{rep.cache_len}, prefill {rep.prefill_tokens} + shared "
          f"{rep.shared_prefill_tokens} tokens, leaked blocks {rep.leaked_blocks}; {name} "
          f"calls at (T, rows) {w} (expected [(1, {rows_per_call})]); pool bytes per shard "
          f"{pool['per_shard_bytes']} (pool_report per_device_bytes "
          f"{pool['per_device_bytes']:.0f} of {pool['total_bytes']:.0f}, {pool['tokens']} "
          f"tokens); first serve {first_s:.2f} s, peak device memory {peak:.2f} GiB",
          flush=True)
    gates = {"widths": w == [(1, rows_per_call)], "pool_bytes": pool["ok"],
             "leaked": rep.leaked_blocks == 0,
             "completed": len(rep.results) == len(reqs) and all(
                 res.tokens.shape == (r.prompt_len + r.max_new,)
                 for r, res in zip(reqs, rep.results))}
    # the first request graphed against op by op, fresh engines (the
    # launches compared once the trace gives the replays' kernels)
    sub = reqs[:SERVE_OP_SUBSET]
    runs = []
    for graphed in (True, False):
        r2 = _LogitRecorder()
        e2 = Engine(model, params, max_new=max_new, sampler=r2)
        if not graphed:
            op_by_op(e2)
        with RouteIds(routes and not graphed) as ids:
            rep2, n2, rows2, _, rp2 = counted_serve(e2, sub, opts, r2)
        runs.append(((rep2, rows2, e2), n2, rp2))
        if routes and not graphed:
            out["routes"] = {"calls": ids.calls, "tokens": rep2.results[0].tokens,
                             "prompt_len": sub[0].prompt_len}
    gvo = serve_graph_vs_op(f"{label}, first {len(sub)} requests", sub, runs[0][0],
                            runs[1][0], gate=False)
    out["captures"] = [len(graph_states(eng))]
    out["pending"] = {"eng": eng, "counted": counted, "replayed": replayed,
                      "per_replay": per_replay, "gates": gates, "gvo": gvo,
                      "sub": (runs[0][1], runs[0][2], runs[1][1]), "t_run": t_run}
    del runs
    if timed:
        # aten ops a replayed greedy step and ms a step: a warm serve by an
        # engine with the greedy sampler (the recorder samples on the
        # host), after one that captures
        eng_t = Engine(model, params, max_new=max_new)
        t_opts = dataclasses.replace(opts, report_cost=False)
        eng_t.serve(reqs, t_opts)
        with StepOps("_serve_decode") as ops:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep_t = eng_t.serve(reqs, t_opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["captures"].append(len(graph_states(eng_t)))
        del eng_t
        out.update(ms_per_step=wall * 1e3 / rep_t.steps, aten_ops_per_replayed_step=ops.per_step)
        gates["aten_ops"] = ops.per_step <= MAX_REPLAYED_STEP_OPS
        print(f"  {label}: {out['ms_per_step']:.3f} ms per step (a warm graphed serve / "
              f"{rep_t.steps} steps, prefills included), host work per step "
              f"{ops.per_step:.1f} aten ops replayed (limit {MAX_REPLAYED_STEP_OPS}), graphs "
              f"captured {out['captures']} (the checked serve's engine, the timed one) "
              f"({card_line()})", flush=True)
    gates["one_capture"] = all(c == 1 for c in out["captures"])
    if base is not None:
        divs = [first_divergence(f"{label} vs single-device, request {a.rid}", a.tokens,
                                 b.tokens, a.prompt_len, model, base["params"])
                for a, b in zip(rep.results, base["rep"].results)]
        divs = [d for d in divs if d is not None]
        al = aligned_logits(f"{label} vs single-device", reqs, rep.results,
                            base["rep"].results, rows, base["rows"])
        same = (not divs and rows_equal(rows, base["rows"]) == len(reqs))
        out.update(equals_single_device_bitwise=same, aligned=al, divergences=divs)
        print(f"  {label} == the single-device serve at {L} layers, bitwise (tokens and every "
              f"step-aligned logit row): {same}; {len(divs)} divergences "
              f"({sum(d['near_tie'] for d in divs)} at near ties)", flush=True)
        gates["vs_single_device"] = same or (
            all(d["near_tie"] for d in divs) and al["max"] <= tol[0] and al["rms"] <= tol[1])
    out["rec"] = {"rep": rep, "rows": rows, "params": params}
    return out


def tp_finish(label, outs, gate=True):
    """The launches of ``tp_serve``'s runs ``outs``: one profiler session
    over every run's replayed graph (``replay_trace``), then each run's
    launches (the wrappers' plus its replays x the kernel calls a replay
    of its graph) against n x layers x requests (K1) and n x layers x
    steps (the fused decode), its first request's graphed launches against
    op by op, and all its gates. ``gate`` False: nothing fails."""
    graphs = {(o["label"], k): g for o in outs
              for k, g in replayed_graphs(o["pending"]["eng"],
                                          o["pending"]["replayed"]).items()}
    traces = replay_trace(label, graphs)
    for o in outs:
        p = o.pop("pending")
        mine = {k: traces[(o["label"], k)] for k in p["replayed"]}
        o["step_trace"] = next(iter(mine.values()))
        o["launches"] = path_launches(o["label"], p["counted"], p["replayed"], mine,
                                      p["per_replay"])
        counted_g, replayed_g, n_o = p["sub"]
        step = {k: o["step_trace"] for k in replayed_g}
        p["gvo"]["launches"] = path_launches(f"{o['label']}, first request graphed", counted_g,
                                             replayed_g, step, p["per_replay"]) == n_o
        gates = p["gates"]
        gates["launches"] = o["launches"] == o["expected_launches"]
        gates["graph_vs_op"] = all(p["gvo"].values())
        o.update(gates=gates, graph_vs_op_by_op=p["gvo"],
                 seconds=time.perf_counter() - p["t_run"])
        print(f"  {o['label']}: launches {o['launches']} (expected "
              f"{o['expected_launches']}); gates {gates}", flush=True)
        if gate:
            check(all(gates.values()), f"{o['label']}: gates fail: {gates}")
    return outs


def qwen32_model(n_layers=None):
    """qwen2.5-32b (``n_layers``: its first layers), softmax int_pallas,
    seeded bf16 weights drawn by ``big_model_params`` (QKV biases
    N(0, QWEN_BIAS_STD))."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model

    over = {} if n_layers is None else {"n_layers": n_layers}
    model = Model(get_config("qwen2.5-32b", softmax=SoftmaxSpec("int_pallas"), **over))
    return model, big_model_params(model, QWEN_BIAS_STD)


def qwen32_trace():
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.scheduler import shared_prefix_trace

    return shared_prefix_trace(32, get_config("qwen2.5-32b").vocab,
                               **SERVE_TRACE)[:QWEN32_REQUESTS]


def _tp_summary(run):
    return {k: v for k, v in run.items() if k != "rec"}


def phase20_tensor_parallel():
    """qwen2.5-32b at full width and depth single-device, then tensor-parallel
    serving over 2 and 4 shards on one card (qwen2.5-32b at TP_LAYERS from
    the bf16 and the int8 pool, minicpm3-4b at TP_MLA_LAYERS), each held
    against the single-device serve at its depth."""
    import dataclasses
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import Model
    from repro_torch.serving.options import ServeOptions

    t_phase = time.perf_counter()
    card = card_line()
    out = {"runs": {}}
    reqs = qwen32_trace()
    opts = ServeOptions(**TP_OPTIONS)
    t0 = time.perf_counter()
    model, params = qwen32_model()
    cfg = model.cfg
    torch.cuda.synchronize()
    print(f"qwen2.5-32b full width and depth ({cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"QKV biases, untied head), seeded bf16 weights "
          f"({sum(v.numel() * v.element_size() for _, v in rl.named_leaves(params)) / 2**30:.2f}"
          f" GiB, drawn in {time.perf_counter() - t0:.1f} s), softmax int_pallas; phase 6's "
          f"trace cut to "
          f"{len(reqs)} requests ({sum(r.max_new for r in reqs)} tokens) with phase 6's "
          f"options ({card})", flush=True)
    runs = out["runs"]
    runs["qwen2.5-32b"] = tp_serve("qwen2.5-32b serve, 64 layers, single-device", model,
                                   params, reqs, opts, 1, "K2", timed=False)
    # (b): the same weights at TP_LAYERS layers, the first TP_REQUESTS
    # requests
    reqs = reqs[:TP_REQUESTS]
    m_b = Model(dataclasses.replace(cfg, n_layers=TP_LAYERS))
    p_b = _layers_of(params, TP_LAYERS)
    for kv_quant, shards in ((False, TP_SHARDS), (True, (4,))):
        pool = "int8" if kv_quant else "bf16"
        m = Model(dataclasses.replace(m_b.cfg, kv_quant=kv_quant)) if kv_quant else m_b
        base = tp_serve(f"qwen2.5-32b serve, {TP_LAYERS} layers, {pool} pool, single-device",
                        m, p_b, reqs, opts, 1, "K2")
        runs[f"qwen2.5-32b {TP_LAYERS} layers {pool}"] = base
        for n in shards:
            runs[f"qwen2.5-32b {TP_LAYERS} layers {pool} TP {n}"] = tp_serve(
                f"qwen2.5-32b serve, {TP_LAYERS} layers, {pool} pool, {n} shards", m, p_b,
                reqs, opts, n, "K2", base=base["rec"])
    # (c): minicpm3-4b over 2 shards, K4 on the gathered latent pool
    mla = Model(get_config("minicpm3-4b", softmax=SoftmaxSpec("int_pallas"),
                           n_layers=TP_MLA_LAYERS))
    p_m = mla.init(torch.Generator("cuda").manual_seed(0))
    m_reqs = _mla_trace()[:TP_REQUESTS]
    m_opts = ServeOptions(slots=MLA_SLOTS, paged=True, block_size=MLA_BS, prefix_share=True,
                          kernel="pallas", report_cost=False)
    base = tp_serve(f"minicpm3-4b serve, {TP_MLA_LAYERS} layers, single-device", mla, p_m,
                    m_reqs, m_opts, 1, "K4")
    runs[f"minicpm3-4b {TP_MLA_LAYERS} layers"] = base
    runs[f"minicpm3-4b {TP_MLA_LAYERS} layers TP 2"] = tp_serve(
        f"minicpm3-4b serve, {TP_MLA_LAYERS} layers, 2 shards", mla, p_m, m_reqs, m_opts, 2,
        "K4", base=base["rec"])
    tp_finish("phase 20", list(runs.values()))
    for run in runs.values():
        run.pop("rec", None)
    del model, params, m_b, p_b, m, base, mla, p_m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 20, ms per step (warm graphed serves, prefills included): "
          f"{ {k: round(v['ms_per_step'], 3) for k, v in runs.items() if 'ms_per_step' in v} }; "
          f"device ms of one replayed step: "
          f"{ {k: round(v['step_trace']['span_ms'], 3) for k, v in runs.items()} } ({card})",
          flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 20 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


def _heads_reversed(collect_heads):
    """The heads gathered in reverse shard order."""
    def collect(outs):
        return collect_heads(list(outs)[::-1])
    return collect


def _last_kv_head_dropped(paged_attend_dense):
    """K2 giving zeros for its last kv-head's rows (installed for the
    sharded serve alone, so every call is a shard's)."""
    def attend(q, k_pool, v_pool, *args, **kw):
        out = paged_attend_dense(q, k_pool, v_pool, *args, **kw).clone()
        out[:, :, -(q.shape[2] // k_pool.shape[2]):] = 0
        return out
    return attend


TP_FAULTS = {"heads gathered out of order": ("repro_torch.models.tensor_parallel",
                                             "_collect_heads", _heads_reversed),
             "a shard's K2 drops its last kv-head": (
                 "repro_torch.kernels.paged_attention.ops", "paged_attend_dense",
                 _last_kv_head_dropped)}


def _experts_reversed(collect_experts):
    """The shards' expert rows gathered in reverse shard order."""
    def collect(outs):
        return collect_experts(list(outs)[::-1])
    return collect


def _last_shard_experts_zero(collect_experts):
    """The last shard's experts giving zeros."""
    def collect(outs):
        outs = list(outs)
        outs[-1] = torch.zeros_like(outs[-1])
        return collect_experts(outs)
    return collect


def _a2a_whole_group_slots(segment_capacity):
    """``"a2a"`` at ``capacity()``'s slots of the whole sequence in each
    segment (a segment of T assignments stands for T * n / k tokens)."""
    from repro_torch.models import moe

    def slots(cfg, seg_assignments):
        return moe.capacity(cfg, seg_assignments * cfg.moe_a2a_segments // cfg.moe_top_k)
    return slots


# phase 16's (e) and (g) faults: the serve's gates must catch the first
# two, (g)'s a2a gates the third
MOE_TP_FAULTS = {"experts gathered out of order": ("repro_torch.models.tensor_parallel",
                                                   "_collect_experts", _experts_reversed),
                 "the last shard's experts give zeros": (
                     "repro_torch.models.tensor_parallel", "_collect_experts",
                     _last_shard_experts_zero)}
A2A_FAULTS = {"a2a at capacity()'s whole-group slots": ("repro_torch.models.moe",
                                                        "segment_capacity",
                                                        _a2a_whole_group_slots)}


def _patched(table, fault):
    """Install ``table[fault]``; returns a function that removes it."""
    import importlib

    mod, attr, wrap = table[fault]
    mod = importlib.import_module(mod)
    saved = getattr(mod, attr)
    setattr(mod, attr, wrap(saved))
    return lambda: setattr(mod, attr, saved)


def phase16_fault_control():
    """Phase 16's (e) and (g) gates against three faults: dbrx-132b at
    MOE_LAYERS over 2 shards with the shards' expert rows gathered in
    reverse shard order, and with the last shard's experts giving zeros,
    each against the single-device serve (the clean sharded serve must
    pass every gate, each fault fail one); and (g)'s a2a layer checks
    with each segment given capacity()'s slots of the whole sequence (the
    clean checks pass, the fault fails one)."""
    from repro_torch.serving.options import ServeOptions
    from repro_torch.serving.scheduler import shared_prefix_trace

    model, params = moe_model("dbrx-132b")
    reqs = shared_prefix_trace(32, model.cfg.vocab, **SERVE_TRACE)[:MOE_REQUESTS]
    opts = ServeOptions(**TP_OPTIONS)
    base = tp_serve(f"phase 16 control, {MOE_LAYERS} layers, single-device", model, params,
                    reqs, opts, 1, "K2", timed=False)
    runs = {}
    for fault in [None] + list(MOE_TP_FAULTS):
        label = fault or "clean"
        undo = _patched(MOE_TP_FAULTS, fault) if fault else None
        try:
            runs[label] = tp_serve(f"phase 16 control, {label}, 2 shards", model, params, reqs,
                                   opts, 2, "K2", base=base["rec"], timed=False,
                                   tol=MOE_TP_TOL["dbrx-132b"])
        finally:
            if undo:
                undo()
    tp_finish("phase 16 control", [base] + list(runs.values()), gate=False)
    check(all(base["gates"].values()), f"phase 16 control, single-device: gates fail: "
          f"{base['gates']}")
    results = []
    for label, run in runs.items():
        failed = [k for k, v in run["gates"].items() if not v]
        results.append({"run": label, "caught_by": failed, "aligned": run["aligned"],
                        "divergences": len(run["divergences"])})
        print(f"  phase 16, {label}: caught by {failed or 'nothing'}", flush=True)
    for fault in [None] + list(A2A_FAULTS):
        undo = _patched(A2A_FAULTS, fault) if fault else None
        try:
            # the fault's no-drop comparison would take 2048 slots a segment
            # (45 GB of expert hidden beside the weights): its capacity-1.0
            # checks alone
            gates = a2a_layer(model, params, gate=False,
                              factors=(A2A_DROPS,) if fault else (A2A_NO_DROP, A2A_DROPS))["gates"]
        finally:
            if undo:
                undo()
        failed = [k for k, v in gates.items() if not v]
        results.append({"run": f"a2a layer, {fault or 'clean'}", "caught_by": failed})
        print(f"  phase 16 (g), {fault or 'clean'}: caught by {failed or 'nothing'}",
              flush=True)
    clean = [r for r in results if r["run"] in ("clean", "a2a layer, clean")]
    check(not any(r["caught_by"] for r in clean), f"a clean phase-16 run fails a gate: {clean}")
    faults = [r for r in results if r not in clean]
    check(all(r["caught_by"] for r in faults), f"a phase-16 fault passes every gate: {faults}")
    return results


def phase20_fault_control():
    """Phase 20's (b) gates against two faults of the sharded forward: the
    heads gathered before ``wo`` in reverse shard order, and every shard's K2
    giving zeros for its last kv-head. qwen2.5-32b at TP_LAYERS (its own
    seeded weights), 2 shards, the bf16 pool, against the single-device
    serve; the clean sharded serve must pass every gate and each fault
    fail one."""
    import importlib

    from repro_torch.serving.options import ServeOptions

    model, params = qwen32_model(TP_LAYERS)
    reqs, opts = qwen32_trace()[:TP_REQUESTS], ServeOptions(**TP_OPTIONS)
    base = tp_serve(f"phase 20 control, {TP_LAYERS} layers, single-device", model, params,
                    reqs, opts, 1, "K2")
    runs = {}
    for fault in [None] + list(TP_FAULTS):
        label = fault or "clean"
        saved = None
        if fault is not None:
            mod, attr, wrap = TP_FAULTS[fault]
            mod = importlib.import_module(mod)
            saved = getattr(mod, attr)
            setattr(mod, attr, wrap(saved))
        try:
            runs[label] = tp_serve(f"phase 20 control, {label}, 2 shards", model, params,
                                   reqs, opts, 2, "K2", base=base["rec"])
        finally:
            if saved is not None:
                setattr(mod, attr, saved)
    tp_finish("phase 20 control", [base] + list(runs.values()), gate=False)
    check(all(base["gates"].values()), f"phase 20 control, single-device: gates fail: "
          f"{base['gates']}")
    results = []
    for label, run in runs.items():
        failed = [k for k, v in run["gates"].items() if not v]
        results.append({"run": label, "caught_by": failed, "aligned": run["aligned"],
                        "divergences": len(run["divergences"])})
        print(f"  phase 20, {label}: caught by {failed or 'nothing'}", flush=True)
    check(not results[0]["caught_by"], f"a clean phase-20 run fails a gate: {results[0]}")
    check(all(r["caught_by"] for r in results[1:]),
          f"a phase-20 fault passes every gate: {results[1:]}")
    return results


# ----------------------------------------------------------------- phase 21

# The dry run's peak (live storages on the meta device) against
# torch.cuda.max_memory_allocated() over one decode step of the same cell
# on the card, from the allocations before its parameters: the caching
# allocator rounds each block up to a multiple of 512 B (a few dozen blocks
# live here: olmo-1b's 24 parameter leaves, 2 cache leaves, the step's
# temporaries), and the plain K1 the meta cell runs keeps other
# temporaries than the kernel, under 1 MiB at these shapes; cuBLAS's
# workspace was allocated by the products of earlier phases and is in
# neither. So the two may differ by at most PEAK_SLACK_BYTES.
PEAK_SLACK_BYTES = 4 * 2**20
# A path's model_work bound above this share of its measured time means
# the count is wrong (a lower bound cannot exceed the time it bounds).
ROOFLINE_SHARE_LIMIT = 1.05
# the peak control: olmo-1b's decode step at phase 4's cache length, at
# this batch and at twice it
PEAK_BATCH = 4


def _dry(arch, shape, softmax, keys=None):
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.launch.dryrun import run_cell

    return run_cell(arch, shape, "card", softmax=SoftmaxSpec(softmax), keys=keys)


def dryrun_peak_control(card):
    """(c): one decode step of olmo-1b (int_pallas, K1) at PEAK_BATCH and
    twice it, op by op on the card, its max_memory_allocated over the
    allocations before the parameters, against the dry run's peak_bytes of
    the same cell; the doubled batch must move both, by amounts within
    the same limit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import kv_cache
    from repro_torch.models.model import Model

    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    cache_len = 544
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    out = {}
    for b in (PEAK_BATCH, 2 * PEAK_BATCH):
        dry = _dry("olmo-1b", ShapeSpec(f"peak control b{b}", "decode", cache_len, b),
                   "int_pallas")
        cache = kv_cache.cache_zeros(cfg, b, cache_len, device="cuda")
        token = torch.zeros((b, 1), dtype=torch.long, device="cuda")
        pos = torch.full((), 512, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits = model.decode_step(params, cache, {"token": token}, pos)[0]
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        check(bool(torch.isfinite(logits).all()), f"peak control b{b}: non-finite logits")
        del logits, cache, token, pos
        torch.cuda.empty_cache()
        predicted = dry["memory"]["peak_bytes"]
        limit = PEAK_SLACK_BYTES
        out[b] = {"predicted_peak_bytes": predicted, "measured_peak_bytes": measured,
                  "difference": measured - predicted, "limit": limit,
                  "argument_bytes": dry["memory"]["argument_bytes"]}
        print(f"  dry run vs card, peak of olmo-1b's decode step at batch {b}, cache "
              f"{cache_len}: predicted {predicted} B (dry run, arguments "
              f"{dry['memory']['argument_bytes']} B), measured {measured} B "
              f"(max_memory_allocated over the allocations before the parameters), "
              f"difference {measured - predicted:+d} B (limit {limit}) ({card})",
              flush=True)
        check(abs(measured - predicted) <= limit,
              f"peak control b{b}: measured {measured} B vs predicted {predicted} B")
    del params, model
    torch.cuda.empty_cache()
    lo, hi = out[PEAK_BATCH], out[2 * PEAK_BATCH]
    moved = {"predicted": hi["predicted_peak_bytes"] - lo["predicted_peak_bytes"],
             "measured": hi["measured_peak_bytes"] - lo["measured_peak_bytes"]}
    print(f"  the control (twice the batch) moved the predicted peak by {moved['predicted']} B "
          f"and the measured by {moved['measured']} B", flush=True)
    check(moved["predicted"] > 0 and moved["measured"] > 0,
          f"peak control: twice the batch moved the peaks by {moved}")
    check(abs(moved["measured"] - moved["predicted"]) <= lo["limit"],
          f"peak control: the doubled batch moved the peaks by {moved}")
    return {"by_batch": out, "moved": moved}


def phase21_dryrun_vs_card(generated, served, training, tp):
    """The dry run (``launch/dryrun.py`` on the meta device, on the host)
    of the cells earlier phases ran, against what they allocated and took:
    (a) its argument bytes (parameters and cache, or train state) equal the
    bytes the phase allocated, exactly; (b) ``roofline.model_work``'s
    bound, the least work of the step (a serve step: over the live keys of
    the step its graph replays; the generate: the mean of its steps), is
    at most ROOFLINE_SHARE_LIMIT of the measured time (one replayed decode
    step's device span; the train step's median wall); (c) the peak
    control (``dryrun_peak_control``); (d) each path's roofline share,
    bound over measured, printed with the card's line."""
    from repro_torch.launch.specs import ShapeSpec

    card = card_line()
    t_phase = time.perf_counter()
    q = tp["runs"]["qwen2.5-32b"]
    tr = training["train"]
    paths = [
        ("olmo-1b generate (phase 4)", "olmo-1b", "int_pallas",
         ShapeSpec("phase 4 generate", "generate", generated["cache_len"],
                   generated["batch"], max_new=generated["max_new"]),
         {"params": generated["param_bytes"], "cache": generated["cache_bytes"]}, None,
         generated["trace"]["span_ms"], "a replayed decode step's device span"),
        ("olmo-1b serve step, bf16 pool (phase 6)", "olmo-1b", "int_pallas",
         ShapeSpec("phase 6 serve step", "decode", served["cache_len"], served["slots"],
                   paged=(served["block_size"], served["num_blocks"])),
         {"params": served["param_bytes"], "cache": served["pool_bytes"]},
         served["step_keys"], served["step_trace"]["span_ms"],
         "a replayed serve step's device span"),
        ("olmo-1b train step (phase 19)", "olmo-1b", "int",
         ShapeSpec("phase 19 train step", "train", tr["seq"], tr["batch"]),
         {"state": tr["state_bytes"]}, None, tr["ms_per_step"], "the median step's wall"),
        ("qwen2.5-32b serve step, 64 layers, single-device (phase 20)", "qwen2.5-32b",
         "int_pallas", ShapeSpec("phase 20 serve step", "decode", q["cache_len"], q["slots"],
                                 paged=(q["block_size"], q["num_blocks"])),
         {"params": q["param_bytes"], "cache": q["pool_bytes"]}, q["step_keys"],
         q["step_trace"]["span_ms"], "a replayed serve step's device span"),
    ]
    out = {}
    for label, arch, smx, shape, allocated, keys, measured_ms, what in paths:
        t0 = time.perf_counter()
        dry = _dry(arch, shape, smx, keys)
        by_name = dry["memory"]["argument_bytes_by_name"]
        got = {k: by_name[k] for k in allocated}
        work = dry["model_work"]
        bound_ms = work["bound_s"] / work["steps"] * 1e3
        share = bound_ms / measured_ms
        out[label] = {"dry_run_s": time.perf_counter() - t0, "argument_bytes": by_name,
                      "allocated_bytes": allocated, "model_work": work,
                      "bound_ms": bound_ms, "measured_ms": measured_ms, "measured": what,
                      "roofline_share": share, "live_keys": keys,
                      "flops_per_device": dry["flops_per_device"],
                      "bytes_per_device": dry["bytes_per_device"],
                      "peak_bytes": dry["memory"]["peak_bytes"]}
        print(f"  dry run vs card, {label}: argument bytes {got} (dry run) vs {allocated} "
              f"(allocated by the phase); model_work bound {bound_ms:.4f} ms a step "
              f"({work['dominant']}: {work['flops'] / work['steps']:.4g} FLOPs, "
              f"{work['bytes'] / work['steps']:.4g} B{f'; live keys {keys}' if keys else ''}) "
              f"against {measured_ms:.4f} ms ({what}): roofline share {share * 100:.2f} %; "
              f"dry run {out[label]['dry_run_s']:.1f} s, counted "
              f"{dry['flops_per_device']:.4g} FLOPs (model_work's figure for the port's code "
              f"{work['impl_flops']:.4g}), {dry['bytes_per_device']:.4g} B unfused, peak "
              f"{dry['memory']['peak_bytes']} B ({card})", flush=True)
        check(got == allocated, f"{label}: the dry run's arguments {got} != the allocation "
              f"{allocated}")
        check(share <= ROOFLINE_SHARE_LIMIT, f"{label}: model_work's bound {bound_ms} ms is "
              f"{share:.2%} of the measured {measured_ms} ms")
    out["peak control"] = dryrun_peak_control(card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 21 in {out['seconds']:.1f} s ({card})", flush=True)
    return out


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
    from repro_torch.launch import roofline as rl

    # phase 1: environment
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc}", flush=True)
    print(card, flush=True)
    rate = rl.hbm_rate(name)

    if fault_mode:
        build.build(["int_softmax", "paged_attention", "paged_attention_mla"])
        t0 = time.perf_counter()
        results = {}
        for fn in (k1_fault_control, k2_fault_control, k4_fault_control, k3_fault_control,
                   fault_control, phase13_fault_control, phase14_fault_control,
                   phase16_fault_control, phase17_fault_control, phase18_fault_control,
                   phase20_fault_control):
            t1 = time.perf_counter()
            results[fn.__name__] = fn()
            print(f"{fn.__name__}: {time.perf_counter() - t1:.1f} s", flush=True)
        print(f"fault control: {time.perf_counter() - t0:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps(results), flush=True)
        return

    # phase 2: build every kernel of the paths, all nvcc processes at once;
    # phases 3 and 4 run on K1 alone while K2-K4 finish building beside them
    t0 = time.perf_counter()
    later = {}

    def build_later():
        try:
            later["logs"] = build.build(["paged_attention", "paged_attention_mla",
                                         "int_attention"])
        except BaseException as e:      # raised again once joined
            later["error"] = e
        later["seconds"] = time.perf_counter() - t0

    builder = threading.Thread(target=build_later)
    builder.start()
    try:
        logs = build.build(["int_softmax"])
    finally:
        int_softmax_s = time.perf_counter() - t0

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    print(f"build: {sorted(logs) or 'int_softmax already built'} in {int_softmax_s:.1f} s; "
          "K2-K4 building beside phases 3 and 4", flush=True)
    t_all = time.perf_counter()
    recs = timed("phase 3 (K1 against its plain version)", phase3_k1, rate)
    generated = timed("phase 4 (generate path, olmo-1b and llama2-7b)", phase4_main_path)
    builder.join()
    if "error" in later:
        raise later["error"]
    logs.update(later["logs"])
    print(f"build: {sorted(logs) or 'already built'} in {later['seconds']:.1f} s (every nvcc "
          f"started together, int_softmax's done in {int_softmax_s:.1f} s; phases 3 and 4 ran "
          "beside the rest)", flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
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
    spec = timed("phase 14 (speculative serve: olmo-1b with n-gram drafts from bf16 and int8 "
                 "pools and with draft models, minicpm3-4b with n-gram drafts; minicpm3-4b "
                 "chunked and preempting)", phase14_speculative)
    variants = timed("phase 15 (the softmax-variant zoo and ap_sim, olmo-1b)",
                     phase15_variants)
    moe = timed("phase 16 (the MoE family: dbrx-132b generate, serve and spec serve on K2 at "
                "GQA 48/8, its MoE layer card vs CPU, its serve over 2 and 4 shards, the a2a "
                "dispatch; deepseek-v2-236b serve on K4 at 128 heads and over 2 shards)",
                phase16_moe)
    recurrent = timed("phase 17 (the recurrent families: mamba2-780m and hymba-1.5b generate, "
                      "hymba-1.5b serve on K2 at GQA 25/5, D 64 and K1 on its rings; both "
                      "chunked, preempting and speculative)", phase17_recurrent)
    encdec_mrope = timed("phase 18 (the encoder-decoder and M-RoPE families: whisper-base "
                         "serve with 1500-frame requests; qwen2-vl-7b generate, serve on K2 at "
                         "GQA 28/4, distinct position streams)", phase18_encdec_mrope)
    print(f"phases 3-18: {time.perf_counter() - t_all:.1f} s", flush=True)
    training = timed("phase 19 (training: full-width olmo-1b steps from f32 masters, the smoke "
                     "step card vs CPU, a full-width checkpoint round trip, the serve launcher "
                     "with --warm-steps)", phase19_training)
    print(f"phases 3-19: {time.perf_counter() - t_all:.1f} s", flush=True)
    tp = timed("phase 20 (tensor-parallel serving: qwen2.5-32b at full width and depth on one "
               f"card; at {TP_LAYERS} layers over 2 and 4 shards on cuda:0 from bf16 and int8 "
               "pools; minicpm3-4b over 2 shards on K4)", phase20_tensor_parallel)
    print(f"phases 3-20: {time.perf_counter() - t_all:.1f} s", flush=True)
    dry = timed("phase 21 (the dry run against the card: phases 4, 6, 19 and 20's cells on "
                "the meta device against their allocations and times; the peak control)",
                phase21_dryrun_vs_card, generated, served, training, tp)
    print(f"phases 3-21: {time.perf_counter() - t_all:.1f} s", flush=True)

    # the kernels line
    main_rec = next(r for r in recs if r["shape"] == "prefill (main path)")
    k2_main = next(r for r in k2_recs if r["shape"] == "decode (main path)")
    k2_int8_main = next(r for r in k2_int8_recs if r["shape"] == "int8 decode (main path)")
    k3_main = next(r for r in k3_recs if r["shape"] == "olmo-1b prefill (main)")
    k4_main = next(r for r in k4_recs if r["shape"] == "decode (main path)")
    k1_by_path = {"generate": generated["launches_K1"],
                  "generate llama2-7b": generated["llama2-7b"]["launches_K1"],
                  "serve olmo-1b": served["launches"]["K1"],
                  "serve minicpm3-4b": mla["launches"]["K1"],
                  "serve olmo-1b int8": served_int8["launches"]["K1"],
                  "generate dbrx-132b": moe["dbrx generate"]["launches_K1"],
                  "serve dbrx-132b": moe["dbrx serve"]["launches"]["K1"],
                  "serve deepseek-v2-236b": moe["deepseek-v2 serve"]["launches"]["K1"],
                  "generate hymba-1.5b": recurrent["hymba-1.5b generate"]["launches_K1"],
                  "serve hymba-1.5b": recurrent["hymba-1.5b serve"]["launches"]["K1"],
                  "spec serve hymba-1.5b":
                      recurrent["hymba-1.5b spec serve"]["launches"]["K1"],
                  "serve whisper-base":
                      encdec_mrope["whisper-base serve"]["launches"]["K1"],
                  "generate qwen2-vl-7b":
                      encdec_mrope["qwen2-vl-7b generate"]["launches_K1"],
                  "serve qwen2-vl-7b": encdec_mrope["qwen2-vl-7b serve"]["launches"]["K1"],
                  "warm-trained serve olmo-1b": training["warm serve"]["launches"]["K1"],
                  **{f"serve {k}": v["launches"]["K1"] for k, v in tp["runs"].items()},
                  **{f"serve {k}": v["launches"]["K1"] for k, v in moe["sharded"].items()}}
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
        "launches_by_path": {"serve olmo-1b": served["launches"]["K2"],
                             "spec serve olmo-1b": spec["runs"]["bf16"]["launches"]["K2"],
                             "serve dbrx-132b": moe["dbrx serve"]["launches"]["K2"],
                             "spec serve dbrx-132b":
                                 moe["dbrx spec serve"]["launches"]["K2"],
                             "serve hymba-1.5b":
                                 recurrent["hymba-1.5b serve"]["launches"]["K2"],
                             "spec serve hymba-1.5b":
                                 recurrent["hymba-1.5b spec serve"]["launches"]["K2"],
                             "serve qwen2-vl-7b":
                                 encdec_mrope["qwen2-vl-7b serve"]["launches"]["K2"],
                             "warm-trained serve olmo-1b":
                                 training["warm serve"]["launches"]["K2"],
                             **{f"serve {k}": v["launches"]["K2"]
                                for k, v in tp["runs"].items() if v["launches"]["K2"]
                                and v["kv_pool"] == "bf16"},
                             **{f"serve {k}": v["launches"]["K2"]
                                for k, v in moe["sharded"].items() if v["launches"]["K2"]}},
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
        "launches_by_path": {
            "serve olmo-1b int8": served_int8["launches"]["K2 on int8 pools"],
            "spec serve olmo-1b int8":
                spec["runs"]["int8 (absmax)"]["launches"]["K2 on int8 pools"],
            **{f"serve {k}": v["launches"]["K2 on int8 pools"]
               for k, v in tp["runs"].items() if v["kv_pool"] == "int8"}},
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
        "launches_by_path": {"serve minicpm3-4b": mla["launches"]["K4"],
                             "spec serve minicpm3-4b": spec["runs"]["minicpm3-4b"]["launches"]["K4"],
                             "serve deepseek-v2-236b":
                                 moe["deepseek-v2 serve"]["launches"]["K4"],
                             **{f"serve {k}": v["launches"]["K4"]
                                for k, v in tp["runs"].items() if v["launches"]["K4"]},
                             **{f"serve {k}": v["launches"]["K4"]
                                for k, v in moe["sharded"].items() if v["launches"]["K4"]}},
        "max_abs_err": max(r["max_abs_err"] for r in k4_recs),
        "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
        "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg.-1 attention
        "shapes": k4_recs,
    }]
    print(json.dumps({"generate": generated,
                      "serve": {"olmo-1b": served, "minicpm3-4b": mla,
                                "olmo-1b int8": served_int8,
                                "olmo-1b chunked + preempting": chunked,
                                "speculative": spec, "variants": variants},
                      "moe": moe, "recurrent": recurrent, "encdec_mrope": encdec_mrope,
                      "training": training, "tensor_parallel": tp,
                      "dry_run_vs_card": dry,
                      "kv_quantize_card_vs_cpu": quantize}, default=str), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
