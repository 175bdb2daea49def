"""Training launcher of the port: AdamW steps from f32 master weights on the
card, with periodic checkpoints and auto-resume (port of
``src/repro/launch/train.py``, same flags, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
        --steps 100 --batch 16 --seq 64 --ckpt-dir /tmp/run1 --device cpu

Run again with the same ``--ckpt-dir`` to resume from its newest
checkpoint; the checkpoints are the reference's format (either package
restores the other's). Runs on the card; ``--device cpu`` runs the plain
PyTorch path. ``--production-mesh`` raises: sharded training is ROADMAP.md
Queue 1 item 23.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.data.synthetic import SyntheticCorpus, family_batch
from repro_torch.distributed.straggler import StragglerMonitor, mitigate
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.step import init_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--softmax", default="fp", choices=["fp", "int", "fp_lowp"])
    ap.add_argument("--M", type=int, default=6)
    ap.add_argument("--N", type=int, default=16)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    return ap


def main(argv=None):
    """Returns (the final TrainState, the first step this run took, the
    loss of each step it took)."""
    args = build_parser().parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh is not ported to repro_torch yet: ROADMAP.md Queue 1 "
            "item 23 (sharded training)")
    spec = (SoftmaxSpec(args.softmax, PrecisionConfig(M=args.M, N=args.N))
            if args.softmax == "int" else SoftmaxSpec(args.softmax))
    cfg = (smoke_config(args.arch, softmax=spec) if args.smoke
           else get_config(args.arch, softmax=spec))
    model = Model(cfg, device=args.device)
    opt = AdamW(lr=cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps))
    step_fn = make_train_step(model, opt, grad_compress=args.grad_compress)
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)

    def cold():
        return init_state(model, opt, torch.Generator(model.device).manual_seed(0),
                          grad_compress=args.grad_compress)

    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every) \
        if args.ckpt_dir else None
    state, start = mgr.restore_or_init(cold) if mgr else (cold(), 0)
    if start:
        print(f"auto-resumed at step {start}")
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={model.device} softmax={cfg.softmax.kind}")

    monitor = StragglerMonitor()
    losses = {}
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.time()
        batch = family_batch(cfg, args.batch, args.seq, seed=i, corpus=corpus)
        state, met = step_fn(state, batch)
        losses[i] = float(met["loss"])      # waits for the step
        rec = monitor.observe(time.time() - t_step)
        if rec.level >= 2:
            acted = mitigate(rec, mgr, state, i)
            print(f"[straggler] {rec.reason} -> {acted}")
        if mgr:
            mgr.maybe_save(i, state)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={losses[i]:.4f} "
                  f"acc={float(met['accuracy']):.3f} "
                  f"lr={float(met['lr']):.2e} "
                  f"{(time.time() - t0) / max(i - start + 1, 1):.2f}s/step")
    if mgr:
        mgr.maybe_save(args.steps, state, force=True)
        print(f"final checkpoint at {args.ckpt_dir}")
    return state, start, losses


if __name__ == "__main__":
    main()
