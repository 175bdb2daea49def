"""What made a CUDA-graph capture fail on the H100 (cuBLAS
EXECUTION_FAILED inside the capture of minicpm3-4b's speculative verify
round, chip_smoke.py phase 14, twice; each time after the warning
"operation not permitted when stream is capturing (function reset)")?

    python3 probes/capture_mode.py --mode global
    python3 probes/capture_mode.py --mode thread_local
    python3 probes/capture_mode.py --collector parent
    python3 probes/capture_mode.py --collector parent --mode thread_local
    python3 probes/capture_mode.py --collector port

Without ``--collector``: a profiler session before each capture.
minicpm3-4b at full width (cut to ``--layers`` layers; seeded random bf16
weights, ``int_pallas``) and its verify round as the serve runs it
(``Engine._spec_state``: paged from the bf16 pool, ``kernel="pallas"``, 8
slots, draft depth 4, K4 at T 5), captured in the error mode ``--mode``
(``global``, CUDA's and torch's default, or ``thread_local``)
``--captures`` times, each after one replay of the round under a
torch.profiler session with CPU and CUDA activity (as chip_smoke.py's
device traces). Prints the captures made and the first that failed, or
none.

With ``--collector``: Python's garbage collector inside a capture. A
captured ``CUDAGraph`` is left in a dead reference cycle (only the
collector frees it); then a bf16 product (cuBLAS) is warmed up and
captured, and inside the capture the step allocates enough Python objects
to run the collector. ``parent``: captured as ``StepGraph`` did before
``serving.graphs.capture`` (``torch.cuda.graph`` in ``--mode``, the
collector on); ``port``: through ``serving.graphs.StepGraph`` as it is. Prints whether the capture
raised, and its error.

A failed capture may leave the context unusable: run each case in its
own process. The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

SLOTS, K, BS = 8, 4, 16
CACHE_LEN = 576


def collector(case, mode):
    """The dead-cycle capture of ``--collector``: returns None, or the
    first line of the error the capture raised."""
    from repro_torch.serving.graphs import StepGraph

    a = torch.randn(256, 256, device="cuda", dtype=torch.bfloat16)
    a @ a                           # cuBLAS's handle, made outside any capture
    torch.cuda.synchronize()
    gc.collect()
    gc.set_threshold(10**9)         # no automatic collection before the capture
    dead = {"graph": torch.cuda.CUDAGraph()}
    with torch.cuda.graph(dead["graph"]):
        dead["out"] = a @ a
    dead["self"] = dead
    del dead

    def step():
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(100)   # the allocations below run the collector, if it is on
            junk = [[i] for i in range(10000)]
            del junk
        return a @ a

    def parent():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=mode):
            step()
        graph.replay()

    try:
        parent() if case == "parent" else StepGraph(step, [a])()
        torch.cuda.synchronize()
    except Exception as e:      # the capture's failure is the reading
        return str(e).splitlines()[0][:300]
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8, help="cut the depth (0: full)")
    ap.add_argument("--captures", type=int, default=150)
    ap.add_argument("--mode", choices=("global", "thread_local"), default="global")
    ap.add_argument("--collector", choices=("parent", "port"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("capture_mode: no CUDA device visible to torch")
    if args.collector:
        error = collector(args.collector, args.mode)
        print(json.dumps({"collector": args.collector,
                          "mode": args.mode if args.collector == "parent" else "StepGraph's",
                          "capture_failed": error is not None, "error": error}), flush=True)
        print(card(), flush=True)
        return
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    depth = {"n_layers": args.layers} if args.layers else {}
    cfg = get_config("minicpm3-4b", softmax=SoftmaxSpec("int_pallas"), **depth)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    eng = Engine(model, params, max_new=8)
    st = eng._spec_state("pallas", SLOTS, CACHE_LEN, (BS, SLOTS * CACHE_LEN // BS), K)
    real_graph = torch.cuda.graph
    torch.cuda.graph = lambda g, **kw: real_graph(g, **dict(kw, capture_error_mode=args.mode))
    t0 = time.perf_counter()
    made, failed = 0, None
    st.run(True)
    for i in range(args.captures):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            st.run(True)
            torch.cuda.synchronize()
        st.graph = None
        try:
            st.run(True)
        except RuntimeError as e:
            failed = {"capture": i + 1, "error": str(e).splitlines()[0][:300]}
            break
        made += 1
    if failed is None:
        torch.cuda.synchronize()
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "mode": args.mode,
                      "captures_after_a_trace": made, "first_failed": failed,
                      "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(card(), flush=True)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


if __name__ == "__main__":
    main()
