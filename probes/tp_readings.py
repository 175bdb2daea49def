"""Readings of ``chip_smoke.py`` phase 20's tensor-parallel serves against
the single-device serve, in one process on the card:

    python3 probes/tp_readings.py

1. K2's chunk plan. qwen2.5-32b at ``TP_LAYERS`` layers (the seeded
   weights of phase 20's fault control), bf16 pool, phase 20's trace, at
   each of ``TP_SHARDS`` shards served twice: K2 planning its chunks for
   the shard's own kv-heads (the port's code), and for the unsharded
   step's (``k2_split_plan`` called with N times the shard's kv-heads,
   so a shard's rows take the single-device step's chunks). Printed for
   each: the step-aligned logits' steps, max and RMS against the
   single-device serve, each divergence's step, top-2 margin and near-tie
   bound, K2's device ms in one replayed step, and ms a step.
2. The depth of phase 20 (b) and (c): ``phase20_tensor_parallel`` at
   ``TP_LAYERS`` and at 16 layers, its seconds; a gate that fails is
   printed, not raised.

The last lines are the card's name and power limit and one JSON object of
the readings.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _reading(run):
    return {"run": run["label"], "steps": run["aligned"]["steps"],
            "max": run["aligned"]["max"], "rms": run["aligned"]["rms"],
            "bitwise": run["equals_single_device_bitwise"],
            "divergences": [{k: d[k] for k in ("step", "margin", "near_tie_bound", "near_tie")}
                            for d in run["divergences"]],
            "k2_device_ms": run["step_trace"]["device_ms"].get("K2"),
            "step_device_ms": run["step_trace"]["span_ms"],
            "ms_per_step": run["ms_per_step"], "gates": run["gates"]}


def k2_plan_readings():
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serving.options import ServeOptions

    layers = cs.TP_LAYERS
    model, params = cs.qwen32_model(layers)
    reqs, opts = cs.qwen32_trace(), ServeOptions(**cs.TP_OPTIONS)
    base = cs.tp_serve(f"qwen2.5-32b, {layers} layers, single-device", model, params, reqs,
                       opts, 1, "K2")
    own = ops.k2_split_plan
    runs = [base]
    for n in cs.TP_SHARDS:
        for plan in ("the shard's", "the unsharded"):
            if plan == "the unsharded":
                ops.k2_split_plan = lambda s, kv, *a, n=n: own(s, kv * n, *a)
            try:
                runs.append(cs.tp_serve(
                    f"qwen2.5-32b, {layers} layers, {n} shards, K2 planned for {plan} kv-heads",
                    model, params, reqs, opts, n, "K2", base=base["rec"]))
            finally:
                ops.k2_split_plan = own
    cs.tp_finish("K2 plan", runs, gate=False)
    out = [_reading(r) for r in runs[1:]]
    for r in out:
        print(f"  {r['run']}: {r['steps']} steps, max {r['max']:.4g}, RMS {r['rms']:.4g}, "
              f"bitwise {r['bitwise']}, divergences {r['divergences']}, K2 {r['k2_device_ms']}"
              f" device ms a replayed step (step {r['step_device_ms']:.4f}), "
              f"{r['ms_per_step']:.3f} ms a step", flush=True)
    return out


def phase20_at(layers):
    gc.collect()
    torch.cuda.empty_cache()
    cs.TP_LAYERS = layers
    t0 = time.perf_counter()
    try:
        cs.phase20_tensor_parallel()
        failed = None
    except SystemExit as e:
        failed = str(e)
    seconds = time.perf_counter() - t0
    print(f"phase 20 at {layers} layers: {seconds:.1f} s, {failed or 'every gate passed'}",
          flush=True)
    return {"layers": layers, "seconds": seconds, "failed": failed}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tp_readings: no CUDA device visible to torch")
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["int_softmax", "paged_attention", "paged_attention_mla"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"k2_plan": k2_plan_readings()}
    # phase 20 at its own depth first: a gate failing at 16 layers ends the
    # run without freeing its weights
    out["depth"] = [phase20_at(layers) for layers in (cs.TP_LAYERS, 16)]
    print(cs.card_line(), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
