"""Does a column-parallel product give a shard's columns the bits of the
whole product? What sets ``chip_smoke.py`` phase 20's sharded serve ==
single-device serve on the card.

    python3 probes/tp_columns.py

A tensor-parallel shard multiplies the step's rows by its slice of a
weight's columns (``serving.sharded.shard_params``: a view of the
engine's weight, ``models/tensor_parallel.py``); the single-device step
multiplies them by the whole weight. For each column-parallel product of
qwen2.5-32b's decode step ([M, 5120] x [5120, N] in bf16, as
``layers.dense_apply`` computes it) at M 8 (a serve step's slots) and 64
(``Model.STEP_MIN_ROWS``), and each shard count, the shard's product is
compared with its columns of the whole product: over the view (what the
port runs) and over a contiguous copy of the slice. Each line counts the
outputs that differ over all shards, and gives the time of the whole and
of one shard's product (CUDA events, median of 50). Then the card's name
and power limit.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

D = 5120
PRODUCTS = {"wq (40 heads x 128)": 5120, "wk / wv (8 kv-heads x 128)": 1024,
            "gate / up (d_ff)": 27648, "head (vocab)": 152064}
SHARDS = (2, 4)
ROWS = (8, 64)


def ms(fn):
    for _ in range(5):
        fn()
    times = []
    for _ in range(50):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main():
    g = torch.Generator("cuda").manual_seed(0)
    for label, n in PRODUCTS.items():
        w = (torch.randn((D, n), generator=g, device="cuda") * D ** -0.5).to(torch.bfloat16)
        for m in ROWS:
            x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)
            whole = x @ w
            for shards in SHARDS:
                cols = n // shards
                views = copies = 0
                for i in range(shards):
                    part = w[:, i * cols:(i + 1) * cols]
                    want = whole[:, i * cols:(i + 1) * cols]
                    views += int((x @ part != want).sum())
                    copies += int((x @ part.contiguous() != want).sum())
                part = w[:, :cols]
                print(f"{label:28s} M {m:3d}, {shards} shards: outputs differing from the "
                      f"whole product's columns: view {views}, contiguous {copies} of "
                      f"{m * n}; ms whole {ms(lambda: x @ w):.4f}, a shard's view "
                      f"{ms(lambda: x @ part):.4f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
