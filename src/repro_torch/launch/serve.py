"""Serving launcher of the port: build a model from seeded weights, then run
batched generation through ``Engine.generate`` — or, with ``--continuous``,
serve a seeded trace of requests through ``Engine.serve`` (``--paged``,
``--prefix-share``, ``--kernel pallas`` for the fused paged decode K2, or
K4 for an MLA architecture such as ``--arch minicpm3-4b``; ``--kv-quant``
for the int8 KV cache; ``--prefill-chunk N`` and ``--preemption`` for
chunked prefill and priority preemption) —
with any ported softmax backend, and report throughput and the AP softmax
cost (port of ``src/repro/launch/serve.py``, same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --softmax int_pallas --warm-steps 0 --no-smoke --batch 4 \\
        --prompt-len 512 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --prefix-share --kernel pallas \\
        --softmax int_pallas --warm-steps 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --prefill-chunk 8 --preemption \\
        --softmax int_pallas --warm-steps 0 --device cpu

Runs on the card; ``--device cpu`` runs the plain PyTorch path. Flags of
later slices are accepted and raise with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.backends import get_backend
from repro_torch.backends.registry import available_backends
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.sampler import available_samplers
from repro_torch.serving.scheduler import random_trace

# flag -> (value that means "unset", ROADMAP.md item of the slice that ports it)
LATER_SLICES = {
    "serve_softmax": (None, "Queue 1 item 12 (softmax-variant zoo)"),
    "ckpt_dir": (None, "Queue 1 item 13 (training and checkpoints)"),
    "warm_steps": (0, "Queue 1 item 13 (training: warm steps); pass "
                      "--warm-steps 0 to serve seeded weights"),
    "speculative": (False, "Queue 1 item 10 (speculative decoding)"),
    "shards": (0, "Queue 1 item 14 (tensor-parallel serving)"),
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
    if args.prefill_chunk is not None and not args.continuous:
        ap.error("--prefill-chunk requires --continuous (it paces "
                 "Engine.serve admissions)")
    # cross-field serve constraints (--prefix-share, --kernel pallas and
    # --preemption require --paged, ...) fail here, before a model is built
    try:
        serve_options = ServeOptions(
            slots=args.slots, policy=args.policy, paged=args.paged,
            block_size=args.block_size, prefix_share=args.prefix_share,
            kernel=args.kernel, prefill_chunk=args.prefill_chunk,
            preemption=args.preemption)
    except ValueError as e:
        ap.error(str(e))

    metered = get_backend(args.softmax).metered
    spec = (SoftmaxSpec(args.softmax, PrecisionConfig(M=args.M, N=args.N))
            if metered else SoftmaxSpec(args.softmax))
    cfg = (smoke_config(args.arch, softmax=spec) if args.smoke
           else get_config(args.arch, softmax=spec))
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True,
                                  kv_quant_scheme=args.kv_quant_scheme)
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
    if args.continuous:
        return serve_trace(eng, args, serve_options)
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


def serve_trace(eng: Engine, args, serve_options: ServeOptions):
    """The ``--continuous`` route: a seeded mixed-length trace through
    ``Engine.serve``, once to warm up (kernel build, meters) and once
    reported."""
    reqs = random_trace(args.requests, eng.model.cfg.vocab, seed=777,
                        prompt_lens=(4, args.prompt_len, 2 * args.prompt_len),
                        max_new_range=(max(args.max_new // 4, 1), args.max_new))
    eng.serve(reqs, options=serve_options)
    rep = eng.serve(reqs, options=dataclasses.replace(serve_options,
                                                      report_cost=True))
    gen = sum(r.max_new for r in reqs)
    lat = [r.latency_s for r in rep.results]
    paged_note = (f", paged bs={rep.block_size} (prefill {rep.prefill_tokens} "
                  f"tok, shared {rep.shared_prefill_tokens})" if rep.paged else "")
    print(f"{args.policy} serving: {len(reqs)} requests / {args.slots} slots, "
          f"{gen} tokens in {rep.steps} decode steps, {rep.wall_s * 1e3:.1f} ms "
          f"({gen / rep.wall_s:.0f} tok/s){paged_note}")
    print(f"request latency p50={np.percentile(lat, 50) * 1e3:.1f} ms "
          f"p99={np.percentile(lat, 99) * 1e3:.1f} ms")
    if args.prefill_chunk is not None or args.preemption:
        print(f"sla: prefill_chunk={rep.prefill_chunk or 'off'} "
              f"(max prefill/step {rep.max_prefill_per_step}), "
              f"preemptions={rep.preemptions} resumes={rep.resumes} "
              f"leaked_blocks={rep.leaked_blocks}")
        for cls in sorted(rep.class_latency):
            c = rep.class_latency[cls]
            sla = ("" if c["sla_attainment"] is None
                   else f"  sla={c['sla_attainment'] * 100:.0f}%")
            print(f"  class {cls}: n={c['n']} "
                  f"ttft p50={c['ttft_p50'] * 1e3:.1f}/"
                  f"p99={c['ttft_p99'] * 1e3:.1f} ms  "
                  f"tbt p50={c['tbt_p50'] * 1e3:.1f}/"
                  f"p99={c['tbt_p99'] * 1e3:.1f} ms"
                  f"{sla}  preempted={c['preemptions']}")
    for r in rep.results[:3]:
        cost = (f"  cost: {r.cost.describe()}"
                if r.cost is not None and r.cost.cycles else "")
        print(f"  rid={r.rid} P={r.prompt_len} new={len(r.tokens) - r.prompt_len} "
              f"lat={r.latency_s * 1e3:.1f} ms{cost}")
    if rep.cost is not None and rep.cost.cycles:
        print(f"batch softmax AP cost: {rep.cost.describe()}")
    return rep


if __name__ == "__main__":
    main()
