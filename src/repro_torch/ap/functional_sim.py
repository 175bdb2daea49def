"""Functional 2D-AP simulator: word-level execution with per-op cycle metering
(a copy of ``src/repro/ap/functional_sim.py``; numpy only).

Where isa.py simulates genuine compare/write LUT passes (bit-exact but slow),
this simulator executes whole ops on int64 arrays — still **bit-exact** with
respect to the configured column widths (every op masks/saturates to its
destination width) — while charging cycles from the Table II cost model. It is
the machine the Fig.-5 dataflow program runs on.

Batched execution: fields are ``[n_rows, n_words]`` — every op applies to all
rows of a batch in one vectorized numpy pass (each row is one softmax vector;
the hardware analogue is one AP per row running the same word-parallel
program in lockstep). ``cycles`` / ``cycle_log`` count ONE row's program —
the per-AP cost, identical for every row since every op is word-parallel and
data-independent in length. A sequential single-AP schedule costs
``cycles * n_rows`` (what ``dataflow.ap_softmax_rows`` reports).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np

from repro_torch.ap import cost_model as cm


@dataclasses.dataclass
class APSim:
    """``n_rows`` APs of ``n_words`` words per column-field (one softmax
    vector per row, 2 words/row of physical CAM)."""
    n_words: int
    n_rows: int = 1

    def __post_init__(self):
        self.fields: Dict[str, np.ndarray] = {}
        self.widths: Dict[str, int] = {}
        self.cycles = 0
        self.cycle_log: Dict[str, int] = {}

    # -- storage ---------------------------------------------------------

    def alloc(self, name: str, width: int, signed_ok: bool = True) -> None:
        self.fields[name] = np.zeros((self.n_rows, self.n_words), np.int64)
        self.widths[name] = width

    def load(self, name: str, values) -> None:
        """Host write (DMA); not charged as compute cycles. ``values`` is
        anything broadcastable to ``[n_rows, n_words]``."""
        v = np.asarray(values, np.int64)
        self.fields[name] = np.broadcast_to(
            v, (self.n_rows, self.n_words)).copy()

    def read(self, name: str) -> np.ndarray:
        return self.fields[name].copy()

    def _charge(self, step: str, cycles: int) -> None:
        self.cycles += cycles
        self.cycle_log[step] = self.cycle_log.get(step, 0) + cycles

    # -- ops (cycle costs from Table II formulas) --------------------------

    def add(self, dst: str, src: str, step: str, cycles: int = None) -> None:
        self._charge(step, cm.cycles_add(self.widths[dst]) if cycles is None else cycles)
        self.fields[dst] = self.fields[dst] + self.fields[src]

    def sub(self, dst: str, src: str, step: str, cycles: int = None) -> None:
        self._charge(step, cm.cycles_add(self.widths[dst]) if cycles is None else cycles)
        self.fields[dst] = self.fields[dst] - self.fields[src]

    def add_const(self, dst: str, const: int, step: str, cycles: int = None) -> None:
        self._charge(step, cm.cycles_add(self.widths[dst]) if cycles is None else cycles)
        self.fields[dst] = self.fields[dst] + const

    def mul_const(self, dst: str, const: int, step: str, cycles: int = None) -> None:
        self._charge(step, cm.cycles_const_mult(self.widths[dst], const)
                     if cycles is None else cycles)
        self.fields[dst] = self.fields[dst] * const

    def square(self, dst: str, src: str, step: str, cycles: int = None) -> None:
        self._charge(step, cm.cycles_mult(self.widths[src] // 2 + 1) if cycles is None else cycles)
        self.fields[dst] = self.fields[src] * self.fields[src]

    def shift_right_const(self, dst: str, k: int, step: str) -> None:
        self._charge(step, 1)  # column re-addressing
        self.fields[dst] = self.fields[dst] >> k

    def shift_var(self, dst: str, amounts: str, q_max: int, step: str,
                  left_bias: int = 0, cycles: int = None) -> None:
        """dst <- dst << (left_bias - q) per word (arithmetic both ways)."""
        self._charge(step, cm.cycles_varshift(self.widths[dst], q_max)
                     if cycles is None else cycles)
        q = self.fields[amounts]
        sh = left_bias - q
        v = self.fields[dst]
        self.fields[dst] = np.where(sh >= 0, v << np.maximum(sh, 0),
                                    v >> np.maximum(-sh, 0))

    def saturate(self, dst: str, width: int, step: str = "saturate") -> None:
        self._charge(step, 1)
        self.fields[dst] = np.minimum(self.fields[dst], (1 << width) - 1)

    def where_mask(self, dst: str, mask, value: int, step: str) -> None:
        """Mask-register write of a constant into masked-off words."""
        self._charge(step, 2)
        m = np.broadcast_to(np.asarray(mask, bool),
                            (self.n_rows, self.n_words))
        self.fields[dst] = np.where(m, self.fields[dst], value)

    def reduce_saturating(self, src: str, saturation: int, step: str,
                          cycles: int = None) -> np.ndarray:
        """2D-AP row-pair tree reduction with a saturating accumulator —
        the hardware realization of core.int_softmax.saturating_sum.
        Returns one total per row: ``[n_rows]`` int64."""
        self._charge(step, cm.cycles_reduction(self.widths[src], self.n_words)
                     if cycles is None else cycles)
        v = self.fields[src].copy()
        length = v.shape[-1]
        n = 1 if length == 0 else 1 << (length - 1).bit_length()
        if n != length:
            pad = np.zeros(v.shape[:-1] + (n - length,), np.int64)
            v = np.concatenate([v, pad], axis=-1)
        while v.shape[-1] > 1:
            v = np.minimum(v[..., 0::2] + v[..., 1::2], saturation)
        return np.minimum(v[..., 0], saturation)

    def divide_by_scalar(self, dst: str, src: str,
                         denom: Union[int, np.ndarray], p_bits: int,
                         step: str, incam: bool = False, cycles: int = None) -> None:
        """dst <- floor(src * 2^p / denom) via restoring long division
        (bit-identical to core.int_softmax.fixedpoint_div). ``denom`` is a
        scalar or a per-row ``[n_rows]`` array."""
        if cycles is not None:
            self._charge(step, cycles)
        elif incam:
            self._charge(step, cm.cycles_division_incam(p_bits, self.widths[src]))
        else:  # reciprocal-multiply costing; result computed exactly either way
            self._charge(step, cm.cycles_mult(p_bits // 4))
        d = np.asarray(denom, np.int64)
        if d.ndim == 1:
            d = d[:, None]
        num = self.fields[src]
        rem = num.copy()
        quo = np.zeros_like(num)
        for _ in range(p_bits):  # bit-serial over result bits, not rows
            rem = rem << 1
            ge = rem >= d
            rem = np.where(ge, rem - d, rem)
            quo = (quo << 1) | ge.astype(np.int64)
        self.fields[dst] = quo
