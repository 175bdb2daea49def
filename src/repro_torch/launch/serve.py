"""Serving launcher of the port: build a model from seeded weights, then run
batched generation through ``Engine.generate`` — or, with ``--continuous``,
serve a seeded trace of requests through ``Engine.serve`` (``--paged``,
``--prefix-share``, ``--kernel pallas`` for the fused paged decode K2, or
K4 for an MLA architecture such as ``--arch minicpm3-4b``; ``--kv-quant``
for the int8 KV cache; ``--prefill-chunk N`` and ``--preemption`` for
chunked prefill and priority preemption; ``--speculative --draft-k N`` for
draft-and-verify decoding with n-gram drafts; ``--serve-softmax KIND`` to
serve a softmax variant with the model's params) — with any registered
softmax backend (the variant zoo ``consmax`` / ``sole`` / ``mive`` and the
functional AP simulator ``ap_sim`` among them), and report throughput and
the AP softmax cost (port of ``src/repro/launch/serve.py``, same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --softmax int_pallas --warm-steps 0 --no-smoke --batch 4 \\
        --prompt-len 512 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --prefix-share --kernel pallas \\
        --softmax int_pallas --warm-steps 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --prefill-chunk 8 --preemption \\
        --softmax int_pallas --warm-steps 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --speculative --draft-k 4 \\
        --softmax int_pallas --warm-steps 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --smoke --continuous --paged --prefix-share --softmax int \\
        --serve-softmax consmax --warm-steps 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --softmax sole --warm-steps 0 --device cpu --max-new 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --smoke --continuous --paged --kernel pallas --prefill-chunk 8 \\
        --preemption --softmax int_pallas --warm-steps 0 --device cpu

``--arch mamba2-780m`` (SSM) and ``--arch hymba-1.5b`` (hybrid) serve
through the same paths; their chunked prefill accrues the budget and
prefills whole, and neither shares prefixes. A prompt longer than
``ssm_chunk`` (256) must be a multiple of it, as in the reference.

The weights: ``--warm-steps N`` (120 by default) trains N AdamW steps
from seed 0's f32 master weights on the synthetic corpus first (against
``fp`` when the serving softmax cannot be differentiated: ``int_pallas``,
``ap_sim``), ``--ckpt-dir DIR`` restores the newest training checkpoint
there instead (the port's or the reference's), ``--warm-steps 0`` serves
seed 0's weights as drawn. Trained or restored masters are cast to the
compute dtype for ``Engine``.

``--shards N`` (with ``--continuous``) serves tensor-parallel over N
shards: the first N visible devices, as the reference's launcher (which
checks jax's devices), or with ``--shards-on-one-device`` all N on the
model's device (the CPU, or one card).

Runs on the card; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.backends import get_backend
from repro_torch.backends.registry import available_backends
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.convert import cast_weights
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.softmax_variants import SoftmaxSpec, spec_backend
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.launch.mesh import SHARDS_ON_ONE_DEVICE, make_serving_mesh, visible_devices
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.options import ServeOptions
from repro_torch.serving.sampler import available_samplers
from repro_torch.serving.scheduler import random_trace
from repro_torch.training.optimizer import AdamW, constant_schedule, cosine_schedule
from repro_torch.training.step import init_state, make_train_step

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (--no-smoke: full width)")
    names = available_backends()
    ap.add_argument("--softmax", default="int", choices=names)
    ap.add_argument("--serve-softmax", default=None, choices=names,
                    help="--continuous: the softmax variant Engine.serve runs "
                         "(ServeOptions.softmax_kind), sharing the model's "
                         "params; e.g. consmax, sole, mive, ap_sim")
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
    ap.add_argument("--speculative", action="store_true",
                    help="--continuous: draft-and-verify decoding (n-gram "
                         "prompt-lookup drafts, one verify step a round)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="--speculative: draft tokens per verify round")
    ap.add_argument("--kernel", default="jnp", choices=("jnp", "pallas"))
    ap.add_argument("--shards", type=int, default=0,
                    help="--continuous: tensor-parallel serving over N shards "
                         "(the first N visible devices)")
    ap.add_argument("--shards-on-one-device", action="store_true",
                    help="--shards: put every shard on the model's device")
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
    if args.shards and not args.continuous:
        ap.error("--shards requires --continuous (it configures Engine.serve)")
    if args.shards and not args.shards_on_one_device:
        kind = torch.device(args.device or "cuda").type
        seen = len(visible_devices(kind))
        if seen < args.shards:
            ap.error(f"--shards {args.shards} needs {args.shards} devices but torch sees "
                     f"{seen} ({kind}); {SHARDS_ON_ONE_DEVICE}")
    if args.prefill_chunk is not None and not args.continuous:
        ap.error("--prefill-chunk requires --continuous (it paces "
                 "Engine.serve admissions)")
    if args.serve_softmax is not None and not args.continuous:
        ap.error("--serve-softmax requires --continuous (it overrides the "
                 "softmax variant for Engine.serve)")
    # cross-field serve constraints (--prefix-share, --kernel pallas and
    # --preemption require --paged, ...) fail here, before a model is built
    try:
        serve_options = ServeOptions(
            slots=args.slots, policy=args.policy, paged=args.paged,
            block_size=args.block_size, prefix_share=args.prefix_share,
            speculative=args.speculative, draft_k=args.draft_k,
            kernel=args.kernel, softmax_kind=args.serve_softmax,
            prefill_chunk=args.prefill_chunk, preemption=args.preemption)
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
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)
    params = serving_params(model, args, corpus)

    sampler_kw = {}
    if args.sampler == "temperature":
        sampler_kw = {"temp": args.temp, "top_k": args.top_k}
    elif args.sampler in ("top_p", "nucleus"):
        sampler_kw = {"p": args.top_p, "temp": args.temp}
    eng = Engine(model, params, max_new=args.max_new, sampler=args.sampler,
                 eos_id=args.eos_id, **sampler_kw)
    if args.shards:
        serve_options = dataclasses.replace(
            serve_options, shards=None if args.shards_on_one_device else args.shards,
            mesh=(make_serving_mesh(args.shards, [model.device] * args.shards)
                  if args.shards_on_one_device else None))
    if args.continuous:
        return serve_trace(eng, args, serve_options)
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
    elif not cfg.uses_attention:
        print("softmax AP cost: 0 (the model has no softmax: SSM token mixing)")
    else:
        print("softmax AP cost: n/a (unmetered fp backend)")
    return res


def serving_params(model: Model, args, corpus: SyntheticCorpus):
    """The weights ``Engine`` serves, in the model's compute dtype: restored
    from ``--ckpt-dir``, warm-trained ``--warm-steps`` steps, or seed 0's
    as drawn. Training runs against ``fp`` when the serving softmax cannot
    be differentiated, as the reference's launcher does."""
    cfg, gen = model.cfg, torch.Generator(model.device).manual_seed(0)
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters on {model.device}")
    if not (args.ckpt_dir or args.warm_steps):
        print("serving seed 0's weights as drawn")
        return model.init(gen)
    train_model = model if spec_backend(cfg.softmax).differentiable else Model(
        cfg.with_softmax(SoftmaxSpec("fp")), device=model.device)
    if args.ckpt_dir:
        opt = AdamW(lr=constant_schedule(1e-3))
        state, step, _ = ckpt.restore(args.ckpt_dir, init_state(train_model, opt, gen))
        print(f"restored step {step} from {args.ckpt_dir}")
    else:
        opt = AdamW(lr=cosine_schedule(1e-2, 20, args.warm_steps))
        state = init_state(train_model, opt, gen)
        step_fn = make_train_step(train_model, opt)
        for i in range(args.warm_steps):
            state, met = step_fn(state, corpus.batch(16, 64, seed=i))
        print(f"warm-trained {args.warm_steps} steps "
              f"(softmax {train_model.cfg.softmax.kind}), loss={float(met['loss']):.3f}")
    return cast_weights(state.params, model.ctx.dtype)


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
    spec_note = (f", speculative k={rep.draft_k} (acceptance {rep.acceptance_rate:.2f})"
                 if rep.speculative else "")
    shard_note = (f", {args.shards} shards{' on one device' * args.shards_on_one_device}"
                  if args.shards else "")
    print(f"{args.policy} serving: {len(reqs)} requests / {args.slots} slots, "
          f"{gen} tokens in {rep.steps} decode steps, {rep.wall_s * 1e3:.1f} ms "
          f"({gen / rep.wall_s:.0f} tok/s){paged_note}{spec_note}{shard_note}")
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
        if rep.speculative and rep.cost_verify is not None:
            print(f"  verify phase: {rep.cost_verify.describe()}")
        if rep.speculative and rep.cost_draft is not None and rep.cost_draft.cycles:
            print(f"  draft phase: {rep.cost_draft.describe()}")
    return rep


if __name__ == "__main__":
    main()
