"""AP micro-architecture: the genuine bit-serial LUT compare/write machinery
(a copy of ``src/repro/ap/isa.py``; numpy only).

This module implements the Associative Processor at the level the paper
describes it (Sec. II-B / Fig. 3): a CAM bit-matrix with key/mask/tag
registers, where arithmetic is a sequence of LUT *passes* — each pass is one
compare (tag rows whose selected bits match the key) followed by one write
(store pattern bits into tagged rows). Running the ADD/SUB LUTs bit-serially
over word columns reproduces integer arithmetic exactly; tests assert this.

The per-operation *pass counts* measured here validate the Table II cycle
formulas used by the (much faster) cost model in cost_model.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class CAM:
    """rows x bits of SRAM-CAM. Columns are allocated to named fields."""
    rows: int
    bits: int

    def __post_init__(self):
        self.mem = np.zeros((self.rows, self.bits), np.uint8)
        self.fields: Dict[str, Tuple[int, int]] = {}
        self._next = 0
        self.compares = 0
        self.writes = 0

    def alloc(self, name: str, width: int) -> None:
        if self._next + width > self.bits:
            raise ValueError(f"CAM out of columns allocating {name}({width})")
        self.fields[name] = (self._next, width)
        self._next += width

    def col(self, name: str, bit: int) -> int:
        start, width = self.fields[name]
        assert 0 <= bit < width, (name, bit, width)
        return start + bit  # bit 0 == LSB

    # -- the two hardware primitives ------------------------------------

    def compare(self, cols: List[int], key: List[int]) -> np.ndarray:
        """Tag rows whose ``cols`` equal ``key``. One compare cycle."""
        self.compares += 1
        tag = np.ones(self.rows, bool)
        for c, k in zip(cols, key):
            tag &= self.mem[:, c] == k
        return tag

    def write(self, cols: List[int], val: List[int], tag: np.ndarray) -> None:
        """Write ``val`` into ``cols`` of tagged rows. One write cycle."""
        self.writes += 1
        for c, v in zip(cols, val):
            self.mem[tag, c] = v

    # -- host-side load/readout (not counted as AP cycles) ---------------

    def load(self, name: str, values: np.ndarray) -> None:
        start, width = self.fields[name]
        v = np.asarray(values, np.int64)
        for b in range(width):
            self.mem[:, start + b] = (v >> b) & 1

    def read(self, name: str, signed: bool = False) -> np.ndarray:
        start, width = self.fields[name]
        out = np.zeros(self.rows, np.int64)
        for b in range(width):
            out |= self.mem[:, start + b].astype(np.int64) << b
        if signed:
            sign = out >= (1 << (width - 1))
            out = np.where(sign, out - (1 << width), out)
        return out


# The in-place ADD LUT (per the 2D-AP reference [26]): per bit position, input
# pattern (carry, b, a) -> write (carry', sum) over (carry, a). Of the eight
# patterns, four are state-changing; they are ordered so that no write creates
# a pattern a *later* pass would wrongly re-match:
#   (0,1,1)->(1,0) creates (1,1,0): identity, safe anywhere
#   (0,1,0)->(0,1) creates (0,1,1): matched only by the pass ABOVE (already ran)
#   (1,0,0)->(0,1) creates (0,0,1): identity
#   (1,0,1)->(1,0) creates (1,0,0): matched only by the pass ABOVE (already ran)
# 4 passes x (1 compare + 1 write) per bit = the "8M" term of Table II.
_ADD_PASSES = [
    ((0, 1, 1), (1, 0)),
    ((0, 1, 0), (0, 1)),
    ((1, 0, 0), (0, 1)),
    ((1, 0, 1), (1, 0)),
]
# in-place two's-complement SUB LUT: a <- a - b with borrow column, same
# no-re-match ordering argument.
_SUB_PASSES = [
    ((0, 1, 0), (1, 1)),
    ((0, 1, 1), (0, 0)),
    ((1, 0, 1), (0, 0)),
    ((1, 0, 0), (1, 1)),
]


def lut_add(cam: CAM, a: str, b: str, carry: str = "carry") -> None:
    """In-place bit-serial a <- a + b via compare/write LUT passes."""
    _, wa = cam.fields[a]
    _, wb = cam.fields[b]
    ccol = cam.col(carry, 0)
    cam.write([ccol], [0], np.ones(cam.rows, bool))  # clear carry
    for bit in range(wa):
        acol = cam.col(a, bit)
        bcol = cam.col(b, bit) if bit < wb else None
        for (c, bb, aa), (nc, s) in _ADD_PASSES:
            if bcol is None:
                if bb == 1:
                    continue  # b bit is implicitly 0 past its width
                tag = cam.compare([ccol, acol], [c, aa])
            else:
                tag = cam.compare([ccol, bcol, acol], [c, bb, aa])
            cam.write([ccol, acol], [nc, s], tag)


def lut_sub(cam: CAM, a: str, b: str, borrow: str = "carry") -> None:
    """In-place bit-serial a <- a - b (two's complement result)."""
    _, wa = cam.fields[a]
    _, wb = cam.fields[b]
    ccol = cam.col(borrow, 0)
    cam.write([ccol], [0], np.ones(cam.rows, bool))
    for bit in range(wa):
        acol = cam.col(a, bit)
        bcol = cam.col(b, bit) if bit < wb else None
        for (c, bb, aa), (nc, s) in _SUB_PASSES:
            if bcol is None:
                if bb == 1:
                    continue
                tag = cam.compare([ccol, acol], [c, aa])
            else:
                tag = cam.compare([ccol, bcol, acol], [c, bb, aa])
            cam.write([ccol, acol], [nc, s], tag)
