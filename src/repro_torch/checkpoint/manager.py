"""Checkpoint manager: periodic saves, keep-k retention, auto-resume (port
of ``src/repro/checkpoint/manager.py``).

A killed job leaves at most one ``.tmp`` directory, which restore ignores
and the next save sweeps; ``restore_or_init`` makes the restart after a
preemption one line in the launcher.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.checkpoint import checkpointer as ckpt


@dataclasses.dataclass
class CheckpointManager:
    root: str
    interval: int = 100          # steps between saves
    keep: int = 3

    def maybe_save(self, step: int, state, extra: Optional[dict] = None,
                   force: bool = False) -> Optional[str]:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return None
        path = ckpt.save(self.root, step, state, extra=extra)
        ckpt.cleanup(self.root, self.keep)
        return path

    def restore_or_init(self, init_fn: Callable[[], object]) -> Tuple[object, int]:
        """Returns (state, next_step): the newest complete checkpoint
        restored into ``init_fn()``'s structure, or ``init_fn()`` and 0 on
        a cold start."""
        step = ckpt.latest_step(self.root)
        if step is None:
            return init_fn(), 0
        state, step, _ = ckpt.restore(self.root, init_fn(), step)
        return state, step + 1

    def latest(self) -> Optional[int]:
        return ckpt.latest_step(self.root)
