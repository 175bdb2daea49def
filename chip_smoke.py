"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: every CUDA kernel of the main path, from ``src/repro_torch/kernels/csrc``;
3. K1 (the Alg.-1 softmax kernel) against its plain PyTorch version, bitwise,
   at the main path's decode and prefill shapes and at edge shapes, with the
   kernel's and the plain version's times and the card's memory bound;
4. the main path: full-width olmo-1b (16 layers, d_model 2048, seeded random
   bf16 weights) through ``Engine.generate(mode="fused")`` with softmax
   ``int_pallas``, batch 4, prompt 512, 32 new tokens. K1 must launch exactly
   16 x 32 = 512 times, and the same model with the plain torch Alg. 1
   (``int``) must give bitwise equal tokens and last logits; then the smoke
   config on the card against the same weights on the CPU;
5. a ``kernels`` JSON line per ported kernel, the card line, and the result
   line ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
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


def k1_case(label, x, mask, cfg, rate, reps=20):
    """Kernel vs plain version on one input, bitwise; returns its record."""
    from repro_torch.kernels.int_softmax import ops
    from repro_torch.kernels.int_softmax.ref import int_softmax_ref

    got = ops.int_softmax_rows(x, cfg, mask)
    want = int_softmax_ref(x, cfg, mask)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K1 {label}: kernel != plain (max abs err {err})")
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
    rows, cols = x.shape
    nbytes = rows * cols * (4 + 4 + (1 if mask is not None else 0))
    bytes_ms = nbytes / rate * 1e3
    ops_ms = rows * cols * K1_OPS_PER_ELEMENT / ALU_RATE * 1e3
    kernel = lambda: ops.int_softmax_rows(x, cfg, mask)  # noqa: E731
    plain = lambda: int_softmax_ref(x, cfg, mask)  # noqa: E731
    rec = {"shape": label, "rows": rows, "cols": cols, "masked": mask is not None,
           "M": cfg.M, "max_abs_err": err,
           "ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel, reps), "plain_call_ms": call_ms(plain, reps),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"K1 {label:<32} [{rows}, {cols}] M={cfg.M} mask={mask is not None}: "
          f"bitwise equal; device ms: kernel {rec['ms']:.4f}, plain "
          f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f} ({rec['bound_by']}, "
          f"{rec['bound_ms'] / rec['ms'] * 100:.1f}% of it); per eager call: kernel "
          f"{rec['call_ms']:.4f}, plain {rec['plain_call_ms']:.4f}", flush=True)
    return rec


def phase3_k1(rate):
    from repro_torch.core.precision import BEST, PrecisionConfig

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def scores(rows, cols):
        return torch.randn((rows, cols), generator=gen, device=dev) * 3.0

    recs = []
    # main path, decode: [batch 4 x heads 16, cache 544], valid_upto at the
    # first decode position (513 valid, 31 not yet written)
    kv = torch.arange(544, device=dev)
    m = (kv <= 512).expand(64, 544).to(torch.uint8).contiguous()
    recs.append(k1_case("decode (main path)", scores(64, 544), m, BEST, rate))
    # main path, prefill: [4 x 16 x 512 query rows, 512], causal
    causal = torch.tril(torch.ones(512, 512, dtype=torch.uint8, device=dev))
    m = causal.repeat(64, 1)
    recs.append(k1_case("prefill (main path)", scores(64 * 512, 512), m, BEST, rate))
    # edges
    recs.append(k1_case("cols 1", scores(64, 1), None, BEST, rate))
    m = (torch.rand((64, 1), generator=gen, device=dev) < 0.5).to(torch.uint8)
    recs.append(k1_case("cols 1, masked", scores(64, 1), m, BEST, rate))
    recs.append(k1_case("cols 1000", scores(256, 1000), None, BEST, rate))
    m = (torch.rand((8, 32768), generator=gen, device=dev) < 0.7).to(torch.uint8)
    recs.append(k1_case("cols 32768 (max_seq)", scores(8, 32768), m, BEST, rate))
    m = (torch.rand((64, 544), generator=gen, device=dev) < 0.7).to(torch.uint8)
    m[0:8] = 0                       # all-masked rows
    m[8:16] = 0
    m[8:16, 100] = 1                 # lone-element rows: v_approx == total
    recs.append(k1_case("all-masked + lone-element rows", scores(64, 544), m, BEST, rate))
    m4 = PrecisionConfig(M=4, T_C=-4.0)
    recs.append(k1_case("prefill rows, M=4 T_C=-4", scores(16 * 512, 512),
                        causal.repeat(16, 1), m4, rate))
    recs.append(k1_case("lone-element rows, M=4 T_C=-4", scores(64, 544),
                        m, m4, rate))
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

    # phase 2: build every kernel of the path, all nvcc processes at once
    t0 = time.perf_counter()
    logs = build.build(["int_softmax"])
    print(f"build: {sorted(logs) or 'already built'} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # phase 3
    recs = phase3_k1(rate)
    # phase 4
    launches = phase4_main_path()

    # phase 5
    main_rec = next(r for r in recs if r["shape"] == "prefill (main path)")
    kernels = [{
        "name": "int_softmax", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int_softmax.cu",
        "replaces": "src/repro/kernels/int_softmax/kernel.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,   # no PyTorch call computes Alg. 1
        "shapes": recs,
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
