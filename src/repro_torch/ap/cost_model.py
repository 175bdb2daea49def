"""2D-AP cost model: cycles per Table II, energy/area from 16 nm constants.

Cycle formulas (Table II of the paper, L = words in the AP, M = bit-width):

    Addition        2M + 8M + M + 1
    Multiplication  2M + 8M^2 + 2M
    Reduction       2M + 8M + 8*log2(L/2) + 1

Extensions the dataflow needs, modeled in the same bit-serial idiom and
documented in DESIGN.md:

  * constant multiply — the multiplier (mu, v_ln2, per-vector reciprocal) is
    known to the controller, so the shift-add runs only over its set bits:
    popcount(const) additions at the accumulating width.
  * variable shift (>> q) — bit-serial column re-addressing; one
    compare/write per output bit per distinct shift value considered.
  * division — realized as reciprocal-multiply: the controller computes
    floor(2^P/sum) once per vector (scalar, off-array) and the AP multiplies
    by it as a constant. (The fully in-CAM restoring division is implemented
    functionally in functional_sim.py; its cost = P subtract passes.)

Energy model: every compare/write cycle activates the whole word-row segment
(rows x active column bits); E = cycles x rows x row_bits x e_cell. The 16 nm
per-cell-per-cycle energy ``E_CELL_FJ`` and the CAM cell area are calibrated
against the paper's anchors (Table VI 5.88e-3 pJ/op; areas 0.64/0.81/1.28 mm^2
for Llama2-7b/13b/70b == 0.02 mm^2 per head-AP at 2048 rows).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.precision import PrecisionConfig

E_CELL_FJ = 0.85          # fJ per cell per compare/write cycle (16 nm, calibrated)
CELL_AREA_UM2 = 0.121     # CAM cell area (16 nm) — fits the 0.02 mm^2/AP anchor
FREQ_HZ = 1.0e9           # Table VI: SoftmAP max frequency 1000 MHz


def cycles_add(m: int) -> int:
    return 2 * m + 8 * m + m + 1


def cycles_mult(m: int) -> int:
    return 2 * m + 8 * m * m + 2 * m


def cycles_reduction(m: int, l_words: int) -> int:
    stages = max(1, math.ceil(math.log2(max(l_words // 2, 2))))
    return 2 * m + 8 * m + 8 * stages + 1


def cycles_const_mult(m_acc: int, const: int) -> int:
    """Shift-add over the constant's set bits (controller knows the constant)."""
    ones = max(1, bin(max(const, 1)).count("1"))
    return ones * cycles_add(m_acc)


def cycles_varshift(m: int, q_max: int) -> int:
    """Per-row shift by a data-dependent q: one masked copy pass per candidate
    shift amount over the m output bits."""
    return max(1, q_max) * (m + 1)


def cycles_division_incam(p_bits: int, m_den: int) -> int:
    """Fully in-CAM restoring division: one compare+subtract+write per
    quotient bit over the denominator width."""
    return p_bits * (8 * m_den + 2)


@dataclasses.dataclass(frozen=True)
class APDesign:
    """One AP instance (the paper deploys one per attention head)."""
    rows: int                      # seq_len / 2 (two words per row, Sec. V-B)
    row_bits: int                  # total allocated column bits (Fig. 4 layout)

    @property
    def cells(self) -> int:
        return self.rows * self.row_bits

    @property
    def area_mm2(self) -> float:
        return self.cells * CELL_AREA_UM2 * 1e-6


def row_bits_for(cfg: PrecisionConfig) -> int:
    """Fig. 4 column budget: A, B operand columns + working columns + R + carry."""
    w = cfg.table1_widths()
    return (w["v"] + w["v"]            # A (v), B (max / second operand)
            + w["poly"]                # widest working column
            + w["sum"]                 # reduction accumulator
            + w["result"]              # R column (2M+12)
            + 2)                       # carry/borrow + tag spill


def softmax_cycle_breakdown(cfg: PrecisionConfig, seq_len: int,
                            incam_division: bool = False) -> Dict[str, int]:
    """Cycles for ONE softmax vector of ``seq_len`` words, executed
    word-parallel on seq_len/2 rows x 2 slots (Fig. 5 steps).

    Costing discipline (matches the paper's description of its simulator:
    "relies on the formulations in Table II to model ... elementary operations
    (addition, multiplication, etc.)"): each Fig.-5 step is ONE Table-II
    elementary op at its operative precision. Multiplies by offline constants
    (mu, v_ln2, the per-vector reciprocal) are Table-II multiplications at the
    constant's stored width; the reduction runs at the sum-accumulator width.
    This reading reproduces the paper's latency-ratio anchors (see
    EXPERIMENTS.md calibration table); the conservative popcount/shift-add
    variants remain available above for sensitivity analysis.
    """
    M = cfg.M
    w = cfg.table1_widths()
    steps = {
        "s1_2_max_sub": cycles_add(M),                              # v - max
        "s3_barrett_mul": cycles_mult(M),                           # v * mu
        "s4_shift_2M": 1,                                           # >> 2M (re-address)
        "s5_mul_vln2": cycles_mult(w["v_ln2"]),                     # q * v_ln2
        "s6_sub_corr": cycles_add(M) + 2,                           # v_corr (+1 correction)
        "s7_add_vb": cycles_add(M),                                 # + v_b
        "s8_square": cycles_mult(M),                                # (.)^2
        "s9_add_vc": cycles_add(2 * M),                             # + v_c
        "s10_varshift_q": cycles_varshift(w["v_approx"], cfg.q_max),# << (F - q)
        "s11_reduction": cycles_reduction(w["sum"], seq_len),       # sum
    }
    if incam_division:
        steps["s12_division"] = cycles_division_incam(cfg.P_out, w["sum"])
    else:
        steps["s12_division"] = cycles_mult(M)  # reciprocal-multiply
    steps["s13_writeback"] = 2 * M
    return steps


def softmax_vector_cost(cfg: PrecisionConfig, seq_len: int,
                        incam_division: bool = False):
    """(cycles, latency_s, energy_j, design) for one softmax vector."""
    cycles = sum(softmax_cycle_breakdown(cfg, seq_len, incam_division).values())
    design = APDesign(rows=max(seq_len // 2, 1), row_bits=row_bits_for(cfg))
    latency = cycles / FREQ_HZ
    energy = cycles * design.cells * E_CELL_FJ * 1e-15
    return cycles, latency, energy, design


# ------------------------------------------------- softmax-variant schedules
#
# Table-II compositions for the variant zoo (core.softmax_variants), built
# from the same elementary-op formulas as the Alg.-1 schedule above so every
# variant's CostReport is comparable cycle-for-cycle. Each breakdown is ONE
# softmax vector of ``seq_len`` words, word-parallel on seq_len/2 rows.

LOG2E_FIXED = 0b101110   # log2(e) ~= 1.0111b at 5 fractional bits (popcount 4)


def consmax_row_bits(cfg: PrecisionConfig) -> int:
    """ConSmax column budget: no sum accumulator (nothing is reduced)."""
    w = cfg.table1_widths()
    return w["v"] + w["v"] + w["poly"] + w["result"] + 2


def consmax_cycle_breakdown(cfg: PrecisionConfig) -> Dict[str, int]:
    """ConSmax (2402.10930): beta-subtract + Alg.-1 integer exp + gamma
    multiply. No reduction and no division — the per-vector cost is
    independent of ``seq_len``, which is the variant's whole pitch."""
    M = cfg.M
    w = cfg.table1_widths()
    return {
        "s1_beta_sub": cycles_add(M),                               # x - beta
        "s2_barrett_mul": cycles_mult(M),                           # v * mu
        "s3_shift_2M": 1,                                           # >> 2M
        "s4_mul_vln2": cycles_mult(w["v_ln2"]),                     # q * v_ln2
        "s5_sub_corr": cycles_add(M) + 2,                           # v_corr
        "s6_add_vb": cycles_add(M),                                 # + v_b
        "s7_square": cycles_mult(M),                                # (.)^2
        "s8_add_vc": cycles_add(2 * M),                             # + v_c
        "s9_varshift_q": cycles_varshift(w["v_approx"], cfg.q_max), # << (F - q)
        "s10_gamma_mul": cycles_mult(M),                            # * gamma
        "s11_writeback": 2 * M,
    }


def sole_row_bits(cfg: PrecisionConfig) -> int:
    """SOLE column budget: the exp column is the v_approx fixed point, the
    poly working column of Alg. 1 disappears (no polynomial)."""
    w = cfg.table1_widths()
    return w["v"] + w["v"] + w["v_approx"] + w["sum"] + w["result"] + 2


def sole_cycle_breakdown(cfg: PrecisionConfig, seq_len: int) -> Dict[str, int]:
    """SOLE-style two-stage schedule: shift-add base-2 exp on the v_approx
    grid, reduction, then a log-domain reciprocal (leading-one detect +
    linear fraction) instead of a divider; applying the per-vector reciprocal
    is a constant multiply at the M-bit stored width — the same discipline
    the Alg.-1 schedule (``softmax_cycle_breakdown`` s12) uses."""
    M = cfg.M
    w = cfg.table1_widths()
    w_lp = w["v_approx"]            # 1.(w_vapprox) fixed point
    return {
        "s1_max_sub": cycles_add(M),                                # x - max
        "s2_log2e_mul": cycles_const_mult(M, LOG2E_FIXED),          # t = x*log2e
        "s3_split": 1,                                              # int/frac re-address
        "s4_frac_add1": cycles_add(w_lp),                           # 1 + frac
        "s5_exp_shift": cycles_varshift(w_lp, w_lp),                # << int(t)
        "s6_round_lp": 1,                                           # grid truncate
        "s7_reduction": cycles_reduction(w["sum"], seq_len),        # sum
        "s8_lod": w["sum"] + 2,                                     # leading-one detect
        "s9_log_frac": cycles_add(w_lp),                            # linear log2 frac
        "s10_recip_mul": cycles_mult(M),                            # e * recip (const)
        "s11_writeback": 2 * M,
    }


def mive_row_bits(cfg: PrecisionConfig) -> int:
    """MIVE column budget: exponent codes live in the v_approx column."""
    w = cfg.table1_widths()
    return w["v"] + w["v_approx"] + w["sum"] + w["result"] + 2


def mive_cycle_breakdown(cfg: PrecisionConfig, seq_len: int) -> Dict[str, int]:
    """MIVE-style shift-add schedule: integer exponents (exp = shift of a
    unit code), reduction, and a single shift-add reciprocal — no multiplier
    cycles anywhere, the minimal lowering of the zoo."""
    M = cfg.M
    w = cfg.table1_widths()
    w_acc = w["v_approx"]           # exp shift range == the column width
    return {
        "s1_max_sub": cycles_add(M),                                # x - max
        "s2_log2e_mul": cycles_const_mult(M, LOG2E_FIXED),          # t = x*log2e
        "s3_round": 1,                                              # to integer exp
        "s4_exp_shift": cycles_varshift(w_acc, w_acc),              # 1 << t
        "s5_reduction": cycles_reduction(w["sum"], seq_len),        # sum
        "s6_lod": w["sum"] + 2,                                     # leading-one detect
        "s7_recip_sub": cycles_add(w_acc),                          # 1.5 - frac/2
        "s8_apply_shift": cycles_varshift(w_acc, w_acc),            # scalar >> -t
        "s9_writeback": 2 * M,
    }


_VARIANT_SCHEDULES = {
    "consmax": (lambda cfg, L: consmax_cycle_breakdown(cfg), consmax_row_bits),
    "sole": (sole_cycle_breakdown, sole_row_bits),
    "mive": (mive_cycle_breakdown, mive_row_bits),
}


def variant_vector_cost(kind: str, cfg: PrecisionConfig, seq_len: int):
    """(cycles, latency_s, energy_j, design) for one variant softmax vector —
    the variant-zoo counterpart of :func:`softmax_vector_cost`."""
    breakdown, row_bits = _VARIANT_SCHEDULES[kind]
    cycles = sum(breakdown(cfg, seq_len).values())
    design = APDesign(rows=max(seq_len // 2, 1), row_bits=row_bits(cfg))
    return (cycles, cycles / FREQ_HZ,
            cycles * design.cells * E_CELL_FJ * 1e-15, design)


def attention_softmax_cost(cfg: PrecisionConfig, seq_len: int, batch: int,
                           n_heads: int, n_rows: int = None,
                           incam_division: bool = False):
    """Whole-model softmax cost: scores [batch, heads, n_rows, seq_len]; one AP
    per head processes its batch*n_rows vectors sequentially (vectors are
    word-parallel inside the AP). Returns dict with latency/energy/area.

    n_rows defaults to seq_len (full prefill attention matrix).
    """
    n_rows = seq_len if n_rows is None else n_rows
    cycles, lat_v, e_v, design = softmax_vector_cost(cfg, seq_len,
                                                     incam_division)
    vectors_per_ap = batch * n_rows
    return {
        "cycles_per_vector": cycles,
        "latency_s": vectors_per_ap * lat_v,       # heads run in parallel
        "energy_j": n_heads * vectors_per_ap * e_v,
        "area_mm2": n_heads * design.area_mm2,
        "design": design,
        "word_ops": n_heads * vectors_per_ap * seq_len * 13,  # 13 dataflow steps
    }
