"""Same-call timing of K3 against builds of its own source with other flags,
on one GPU.

    python3 probes/k3_variants.py [-DFLAG[=VALUE] ...]
    python3 probes/k3_variants.py --q-rows

Each argument is one variant: ``src/repro_torch/kernels/csrc/int_attention.cu``
built with that flag. Without arguments it takes ``-DK3_MMA_SYNC``: the bf16
scores on mma.sync, each warp reading the K tile by ldmatrix, and the tiles
by 16-byte cp.async, instead of wgmma and TMA.

Each variant is built beside the shipped kernel, its ptxas report printed,
checked bitwise against the shipped kernel (outputs and probabilities), and
timed with it in turns (shipped, variant, variant, shipped) at the
full-width bf16 shapes of ``chip_smoke.py``'s phase 12: CUDA-graph replays,
as ``chip_smoke.py`` times K3. Prints one line a shape and variant, then
the card's name and power limit.

``--q-rows`` times the shipped kernel at each shape with CTAs of 64 and of
128 query rows (one or two warpgroups: the plan's choice, ref.py:k3_tiles),
in turns, after checking that both give the same bits.
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
from repro_torch.kernels.int_attention import ops  # noqa: E402
from repro_torch.kernels.int_attention.ref import k3_tiles  # noqa: E402
from repro_torch.kernels.int_softmax.ops import alg1_consts  # noqa: E402

DEFAULT_VARIANTS = ("-DK3_MMA_SYNC",)
# label -> (B, H, KV, Sq, Skv, D, window)
SHAPES = {"olmo-1b prefill B 4 H 16 S 512": (4, 16, 16, 512, 512, 128, 0),
          "4096 tokens B 1 H 16": (1, 16, 16, 4096, 4096, 128, 0),
          "GQA 32/8, 2048 tokens": (1, 32, 8, 2048, 2048, 128, 0)}



def variant_library(flag: str) -> ctypes.CDLL:
    """K3 built from int_attention.cu with ``flag``; prints its ptxas lines."""
    out_dir = build.BUILD_DIR / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{flag.strip('-').replace('=', '_')}.so"
    log = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, flag, "-o", str(lib),
                          str(build.CSRC / "int_attention.cu")], check=True,
                         capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  {flag} ptxas: {line.strip()}", flush=True)
    dll = ctypes.CDLL(str(lib))
    dll.int_attention_launch.argtypes = ops._library().int_attention_launch.argtypes
    dll.int_attention_launch.restype = ctypes.c_int
    return dll


def tiles_of(name, q):
    """The tiles a build takes: the plan's (ref.py:k3_tiles), but 64 query
    rows for -DK3_MMA_SYNC (the cp.async paths' CTA)."""
    bh, sq, d = q.shape
    q_tile, k_tile = k3_tiles(q.dtype, d, bh, sq,
                              torch.cuda.get_device_properties(0).multi_processor_count)
    return (64 if "K3_MMA_SYNC" in name else q_tile), k_tile


def launch(lib, q, k, v, out, probs, window, tiles):
    bh, sq, d = q.shape
    q_tile, k_tile = tiles
    shape = ops.AttnShape(BH=bh, group=bh // k.shape[0], Sq=sq, Skv=k.shape[1], D=d, causal=1,
                          window=window, q_tile=q_tile, k_tile=k_tile, scale=d ** -0.5)
    ptr = [x.data_ptr() for x in (q, k, v, out)] + [None, None if probs is None
                                                     else probs.data_ptr()]
    rc = lib.int_attention_launch(*ptr, 0, shape, alg1_consts(BEST),
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")


def q_rows():
    """The shipped kernel with 64- and 128-row CTAs at each shape."""
    lib = ops._library()
    gen = torch.Generator("cuda").manual_seed(0)
    for label, (b, h, kv, sq, skv, d, window) in SHAPES.items():
        q = torch.randn((b * h, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b * kv, skv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        outs = {rows: torch.empty((b * h, sq, d), device="cuda") for rows in (64, 128)}
        for rows, out in outs.items():
            launch(lib, q, k, v, out, None, window, (rows, 64))
        torch.cuda.synchronize()
        if not torch.equal(outs[64], outs[128]):
            raise SystemExit(f"{label}: 64- and 128-row CTAs give other bits")
        times = {64: [], 128: []}
        for rows in (64, 128, 128, 64):
            times[rows].append(chip_smoke.device_ms(
                lambda r=rows: launch(lib, q, k, v, outs[r], None, window, (r, 64))))
        print(f"{label}, query rows a CTA: bitwise equal; device ms, 64 rows "
              f"{times[64][0]:.4f} / {times[64][1]:.4f}, 128 rows {times[128][0]:.4f} / "
              f"{times[128][1]:.4f}; the plan takes {tiles_of('', q)[0]}", flush=True)
    print(chip_smoke.card_line(), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if sys.argv[1:] == ["--q-rows"]:
        q_rows()
        return
    flags = sys.argv[1:] or DEFAULT_VARIANTS
    shipped = ops._library()
    libs = {flag: variant_library(flag) for flag in flags}
    gen = torch.Generator("cuda").manual_seed(0)
    for label, (b, h, kv, sq, skv, d, window) in SHAPES.items():
        q = torch.randn((b * h, sq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b * kv, skv, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        for name, lib in libs.items():
            pair = {"shipped": shipped, name: lib}
            res = {}
            for side, side_lib in pair.items():
                out = torch.empty((b * h, sq, d), device="cuda")
                probs = torch.zeros((b * h, sq, skv), device="cuda")
                launch(side_lib, q, k, v, out, probs, window, tiles_of(side, q))
                res[side] = (out, probs)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(res["shipped"], res[name])):
                raise SystemExit(f"{label}: {name} differs from the shipped kernel")
            out = res["shipped"][0]
            del res
            times = {side: [] for side in pair}
            for side in ("shipped", name, name, "shipped"):
                times[side].append(chip_smoke.device_ms(
                    lambda s=side: launch(pair[s], q, k, v, out, None, window,
                                          tiles_of(s, q))))
            print(f"{label}, {name}: bitwise equal; device ms, shipped "
                  f"{times['shipped'][0]:.4f} / {times['shipped'][1]:.4f}, {name} "
                  f"{times[name][0]:.4f} / {times[name][1]:.4f}", flush=True)
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
