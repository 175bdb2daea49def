"""Does a prefill product's row depend on how many rows share the product?
What sets ``chip_smoke.py`` phase 13's chunked == whole on the card.

    python3 probes/prefill_rows.py

A prompt prefilled whole multiplies all its rows at once; committed in
chunks, each piece multiplies its own rows. The two agree bitwise only if
every product gives a row the same bits whatever the row count. For each
GEMM setting below and each prefill projection shape of olmo-1b and
llama2-7b ([M, K] x [K, N], bf16, as ``layers.dense_apply`` computes it),
the first M rows of a 2048-row product are compared with the product of
those M rows alone, for M from 1 to 1024. Settings: PyTorch's defaults;
reduced-precision reductions disallowed
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
each BLAS library (``torch.backends.cuda.preferred_blas_library``); and,
in a process of its own, no cuBLAS workspace (``CUBLAS_WORKSPACE_CONFIG``
and ``CUBLASLT_WORKSPACE_SIZE``; split-K needs one). Each line gives the
row counts whose rows differ, and the time of the decode-shape product
(8 rows) under that setting, CUDA events, median of 50. Then the card's
name and power limit.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

SHAPES = {"olmo-1b wq/wk/wv/wo": (2048, 2048), "olmo-1b gate/up": (2048, 8192),
          "olmo-1b down": (8192, 2048), "llama2-7b gate/up": (4096, 11008),
          "llama2-7b down": (11008, 4096)}
ROWS = (1, 8, 16, 64, 100, 128, 200, 256, 384, 400, 512, 1000, 1024)


def decode_ms(x, w):
    a = x[:, :8]
    for _ in range(5):
        a @ w
    times = []
    for _ in range(50):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        a @ w
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def run(setting: str) -> None:
    g = torch.Generator("cuda").manual_seed(0)
    for label, (k, n) in SHAPES.items():
        w = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(torch.bfloat16)
        x = torch.randn((1, 2048, k), generator=g, device="cuda").to(torch.bfloat16)
        whole = x @ w
        differ = [m for m in ROWS if not torch.equal(x[:, :m] @ w, whole[:, :m])]
        print(f"{setting:>40s} | {label:20s} [M, {k}] x [{k}, {n}]: rows differing from the "
              f"2048-row product's at M = {differ or 'none'}; 8-row product "
              f"{decode_ms(x, w):.4f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("prefill_rows: no CUDA device visible to torch")
    if sys.argv[1:] == ["--child"]:
        run("no cuBLAS workspace")
        return
    run("defaults")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    run("no reduced-precision reduction")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for lib in ("cublas", "cublaslt"):
        torch.backends.cuda.preferred_blas_library(lib)
        run(f"preferred library {lib}")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0", CUBLASLT_WORKSPACE_SIZE="0")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child"], env=env, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
