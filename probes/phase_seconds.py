"""Seconds of chosen ``chip_smoke.py`` phases of a given checkout, each run
as ``chip_smoke.py`` runs it, in one process on the card:

    python3 probes/phase_seconds.py --root . --phases 19 17
    python3 probes/phase_seconds.py --root build/parent --phases 17
    python3 probes/phase_seconds.py --root . --phases 17-faults   # phase 17's fault control
    python3 probes/phase_seconds.py --root . --phases 5 7 16 16-faults

``--root`` is a checkout of the repository (this one, or a parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists): its
``chip_smoke.py`` and ``src`` are imported, nothing of this checkout. The
kernels the phases run are built first (``repro_torch.kernels.build``),
then each phase is called in the order given and its seconds printed, with
the card's name and power limit. Run one ``--root`` a process: two
checkouts' ``repro_torch`` cannot share one. Comparing a phase before and
after a change: parent, change, change, parent, in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

# phase -> (the chip_smoke.py function, the kernels it launches)
PHASES = {
    "4": ("phase4_main_path", ["int_softmax"]),
    "5": ("phase5_k2", ["paged_attention"]),
    "7": ("phase7_k4", ["paged_attention_mla"]),
    "13": ("phase13_chunked_preempt", ["int_softmax", "paged_attention", "paged_attention_mla"]),
    "14": ("phase14_speculative", ["int_softmax", "paged_attention", "paged_attention_mla"]),
    "16": ("phase16_moe", ["int_softmax", "paged_attention", "paged_attention_mla"]),
    "17": ("phase17_recurrent", ["int_softmax", "paged_attention"]),
    "18": ("phase18_encdec_mrope", ["int_softmax", "paged_attention"]),
    "19": ("phase19_training", ["int_softmax", "paged_attention"]),
    "20": ("phase20_tensor_parallel", ["int_softmax", "paged_attention", "paged_attention_mla"]),
    "13-faults": ("phase13_fault_control", ["int_softmax", "paged_attention"]),
    "14-faults": ("phase14_fault_control", ["int_softmax", "paged_attention",
                                            "paged_attention_mla"]),
    "16-faults": ("phase16_fault_control", ["int_softmax", "paged_attention"]),
    "17-faults": ("phase17_fault_control", ["int_softmax", "paged_attention"]),
    "20-faults": ("phase20_fault_control", ["int_softmax", "paged_attention"]),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="a checkout of the repository")
    ap.add_argument("--phases", nargs="+", required=True, choices=sorted(PHASES))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase_seconds: no CUDA device visible to torch")
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(sorted({k for p in args.phases for k in PHASES[p][1]}))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    seconds = {}
    from repro_torch.launch import roofline as rl

    for p in args.phases:
        fn = getattr(cs, PHASES[p][0])
        t0 = time.perf_counter()
        # the kernel phases take the card's HBM rate, as chip_smoke.main
        # passes it
        fn(rl.hbm_rate(torch.cuda.get_device_name(0))) if p in ("5", "7") else fn()
        seconds[p] = time.perf_counter() - t0
        print(f"phase {p} ({PHASES[p][0]}, {root}): {seconds[p]:.1f} s", flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"root": root, "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
