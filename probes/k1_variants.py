"""Same-call timing of K1 against a variant of its own source, on one GPU.

    python3 probes/k1_variants.py

The variant builds ``src/repro_torch/kernels/csrc/int_softmax.cu`` with
``-DK1_INT64_DIVISION``: each probability by ``alg1_prob`` (an int64
division per element, K1's form before) instead of ``alg1_prob_row`` (a
reciprocal per row, 32-bit products per element).

The variant is built beside the shipped kernel, checked bitwise against
the plain version, and timed with it in turns (shipped, variant, variant,
shipped) at the main path's shapes: CUDA-graph replays, as
``chip_smoke.py`` times K1. Prints one line a shape, then the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.core.precision import BEST  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.int_softmax import ops  # noqa: E402
from repro_torch.kernels.int_softmax.ref import int_softmax_ref  # noqa: E402

VARIANT = "int64 division"


def variant_library() -> ctypes.CDLL:
    """K1 built from int_softmax.cu with -DK1_INT64_DIVISION."""
    out_dir = build.BUILD_DIR / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libint64_division.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DK1_INT64_DIVISION", "-o",
                    str(lib), str(build.CSRC / "int_softmax.cu")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.int_softmax_launch.argtypes = ops._library().int_softmax_launch.argtypes
    dll.int_softmax_launch.restype = ctypes.c_int
    return dll


def launch(lib, x, mask, out):
    plan = ops.launch_plan(x)
    rc = lib.int_softmax_launch(
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        plan.per_thread, plan.rows_per_cta, plan.cluster, ops.alg1_consts(BEST),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    shipped = ops._library()
    libs = {VARIANT: variant_library()}
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    # label -> (query rows, keys, blocks of rows): query t of a block sees
    # keys <= keys - rows + t (causal behind a prefix)
    shapes = {"generate prefill [32768, 512]": (512, 512, 64),
              "MLA whole prefill [20480, 512]": (512, 512, 40),
              "MLA tail [5120, 512]": (128, 512, 40),
              "olmo tail [2048, 512]": (128, 512, 16),
              "decode [64, 544]": (1, 544, 64)}
    for label, (n, keys, blocks) in shapes.items():
        qpos = keys - n + torch.arange(n, device=dev)
        if n == 1:
            qpos = qpos - 31                      # 513 of 544 keys written
        mask = (torch.arange(keys, device=dev)[None] <= qpos[:, None]).to(torch.uint8)
        mask = mask.repeat(blocks, 1).contiguous()
        x = torch.randn(mask.shape, generator=gen, device=dev) * 3.0
        want = int_softmax_ref(x, BEST, mask)
        for name, lib in libs.items():
            outs = {"shipped": torch.empty_like(x), name: torch.empty_like(x)}
            pair = {"shipped": shipped, name: lib}
            for side, side_lib in pair.items():
                launch(side_lib, x, mask, outs[side])
            torch.cuda.synchronize()
            for side in pair:
                if not torch.equal(outs[side], want):
                    raise SystemExit(f"{label}: {side} differs from the plain version")
            times = {side: [] for side in pair}
            for side in ("shipped", name, name, "shipped"):
                times[side].append(chip_smoke.device_ms(
                    lambda s=side: launch(pair[s], x, mask, outs[s])))
            print(f"{label}, {name}: bitwise equal; device ms, shipped "
                  f"{times['shipped'][0]:.4f} / {times['shipped'][1]:.4f}, {name} "
                  f"{times[name][0]:.4f} / {times[name][1]:.4f}", flush=True)
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
