"""AdamW and learning-rate schedules (port of
``src/repro/training/optimizer.py``).

Parameters, gradients and moments are nested dicts of tensors in one
layout (the parameter tree). The state keeps the reference's field names,
which the checkpoint keys use (``opt/step``, ``opt/m/...``,
``opt/v/...``). The step stays an int32 tensor on the parameters' device
and the schedules compute in f32 from it, so an update reads nothing back
to the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.kv_cache import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: object                # tree like params
    v: object                # tree like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return AdamWState(step, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(new params, new state, the gradients' global norm before
        clipping). New tensors throughout: ``state`` and ``params`` are
        left as they were. Weight decay applies to every leaf."""
        step = state.step + 1
        gnorm = global_norm(grads)
        if self.clip_norm:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state.v, grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
        lr = self.lr(step)

        def upd(p, mm, vv):
            mhat = mm / bc1
            vhat = vv / bc2
            return p - lr * (mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p)

        return tree_map(upd, params, m, v), AdamWState(step, m, v), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor_frac``
    of it at ``total``; f32 from the int32 step."""
    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.full((), lr_val, dtype=torch.float32, device=step.device)
