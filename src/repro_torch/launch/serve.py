"""Serving launcher of the port: build a model from seeded weights, then run
batched generation through ``Engine.generate`` with any ported softmax
backend, and report throughput and the batch's AP softmax cost (port of the
default, non-continuous route of ``src/repro/launch/serve.py``, same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --softmax int_pallas --warm-steps 0 --no-smoke --batch 4 \\
        --prompt-len 512 --max-new 32

Runs on the card; ``--device cpu`` runs the plain PyTorch path. Flags of
later slices are accepted and raise with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.backends import get_backend
from repro_torch.backends.registry import available_backends
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import available_samplers

# flag -> (value that means "unset", ROADMAP.md item of the slice that ports it)
LATER_SLICES = {
    "continuous": (False, "Queue 1 item 6 (continuous batching)"),
    "serve_softmax": (None, "Queue 1 item 12 (softmax-variant zoo)"),
    "ckpt_dir": (None, "Queue 1 item 13 (training and checkpoints)"),
    "warm_steps": (0, "Queue 1 item 13 (training: warm steps); pass "
                      "--warm-steps 0 to serve seeded weights"),
    "paged": (False, "Queue 1 item 7 (paged KV)"),
    "prefix_share": (False, "Queue 1 item 7 (prefix sharing)"),
    "speculative": (False, "Queue 1 item 10 (speculative decoding)"),
    "kernel": ("jnp", "Queue 2 K2 (fused paged decode)"),
    "shards": (0, "Queue 1 item 14 (tensor-parallel serving)"),
    "prefill_chunk": (None, "Queue 1 item 9 (chunked prefill)"),
    "preemption": (False, "Queue 1 item 9 (preemption)"),
    "kv_quant": (False, "Queue 1 item 8 (int8 KV pool)"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (--no-smoke: full width)")
    names = available_backends()
    ap.add_argument("--softmax", default="int", choices=names)
    ap.add_argument("--serve-softmax", default=None, choices=names)
    ap.add_argument("--M", type=int, default=6)
    ap.add_argument("--N", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--warm-steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--sampler", default="greedy", choices=available_samplers())
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--eager", action="store_true",
                    help="per-token host round trip (baseline)")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="continuous", choices=["continuous", "gang"])
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-share", action="store_true")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--kernel", default="jnp", choices=("jnp", "pallas"))
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--kv-quant-scheme", default="absmax",
                    choices=("absmax", "exaq", "exaq_clamped"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, (unset, item) in LATER_SLICES.items():
        if getattr(args, flag) != unset:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to repro_torch yet: "
                f"ROADMAP.md {item}")

    metered = get_backend(args.softmax).metered
    spec = (SoftmaxSpec(args.softmax, PrecisionConfig(M=args.M, N=args.N))
            if metered else SoftmaxSpec(args.softmax))
    cfg = (smoke_config(args.arch, softmax=spec) if args.smoke
           else get_config(args.arch, softmax=spec))
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters from seed 0 "
          f"on {model.device}")

    sampler_kw = {}
    if args.sampler == "temperature":
        sampler_kw = {"temp": args.temp, "top_k": args.top_k}
    elif args.sampler in ("top_p", "nucleus"):
        sampler_kw = {"p": args.top_p, "temp": args.temp}
    eng = Engine(model, params, max_new=args.max_new, sampler=args.sampler,
                 eos_id=args.eos_id, **sampler_kw)
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)
    prompts = corpus.sample(args.batch, args.prompt_len, seed=777)[:, :args.prompt_len]
    mode = "eager" if args.eager else "fused"
    # warm-up: kernel build, library init, the memoized AP cost meter
    eng.generate(prompts, report_cost=True, mode=mode)
    t0 = time.perf_counter()
    res = eng.generate(prompts, report_cost=True, mode=mode)
    dt = time.perf_counter() - t0
    print(f"{mode} generation: {args.batch}x{args.max_new} tokens "
          f"in {dt * 1e3:.1f} ms ({args.batch * args.max_new / dt:.0f} tok/s)")
    for row in res.tokens[:2]:
        p, g = row[:args.prompt_len].tolist(), row[args.prompt_len:].tolist()
        print(f"  prompt {p[:8]}{'...' if len(p) > 8 else ''} -> {g}")
    if res.cost is not None and res.cost.cycles:
        print(f"softmax AP cost (batch of {args.batch}): {res.cost.describe()}")
    else:
        print("softmax AP cost: n/a (unmetered fp backend)")
    return res


if __name__ == "__main__":
    main()
