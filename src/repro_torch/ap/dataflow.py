"""The Fig.-5 dataflow: SoftmAP's integer softmax as an AP program (a copy
of ``src/repro/ap/dataflow.py``; numpy only).

Runs on the functional 2D-AP simulator and is held **bit-identical** to the
plain torch Alg. 1 (``core.alg1.int_softmax_from_codes``) and to the
reference's program in tests — the software/hardware halves of the
co-design compute the same integers.

The program is written batched: every step is one vectorized numpy pass over
a ``[R, L]`` field (R rows × L words), so the ``ap_sim`` serving backend pays
one host round trip executing all the rows of a softmax call at vector
speed instead of a Python loop per row. ``ap_softmax_vector`` is the R=1
view of the same program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.ap.functional_sim import APSim
from repro_torch.core.precision import PrecisionConfig


def ap_softmax_batch(v_rows: np.ndarray, cfg: PrecisionConfig,
                     mask: Optional[np.ndarray] = None,
                     incam_division: bool = False) -> Tuple[np.ndarray, APSim]:
    """[R, L] codes (scale S, any sign) through the 13-step Fig.-5 program in
    one vectorized pass. Returns ([R, L] probability codes, APSim whose
    cycle log prices ONE row's program — see functional_sim docstring)."""
    v = np.asarray(v_rows, np.int64)
    R, L = v.shape
    w = cfg.table1_widths()
    from repro_torch.ap.cost_model import softmax_cycle_breakdown
    br = softmax_cycle_breakdown(cfg, L, incam_division)
    ap = APSim(L, n_rows=R)
    for name, width in [("A", w["v"]), ("B", w["v"]), ("NEG", 2 * cfg.M),
                        ("Q", 2 * cfg.M), ("QL", 2 * cfg.M),
                        ("R", w["result"]), ("P", w["poly"]),
                        ("VA", w["v_approx"]), ("OUT", w["result"])]:
        ap.alloc(name, width)

    if mask is not None:
        mask = np.asarray(mask, bool)
        v = np.where(mask, v, -(1 << (cfg.M - 1)))

    # steps 1-2: write v and per-row max(v) into A/B, word-parallel subtract
    ap.load("A", v)
    row_max = (v.max(axis=-1, keepdims=True) if L
               else np.zeros((R, 1), np.int64))
    ap.load("B", np.broadcast_to(row_max, (R, L)))
    ap.sub("A", "B", "s1_2_max_sub", cycles=br["s1_2_max_sub"])
    ap.fields["A"] = np.maximum(ap.fields["A"], -(1 << (cfg.M - 1)))  # M-bit floor

    # step 3: Barrett multiply  NEG <- (-v_stable) * mu
    ap.load("NEG", -ap.fields["A"])
    ap.mul_const("NEG", cfg.mu, "s3_barrett_mul", cycles=br["s3_barrett_mul"])
    # step 4: q <- NEG >> 2M
    ap.load("Q", ap.fields["NEG"])
    ap.shift_right_const("Q", 2 * cfg.M, "s4_shift_2M")
    # step 5: QL <- q * v_ln2
    ap.load("QL", ap.fields["Q"])
    ap.mul_const("QL", cfg.v_ln2, "s5_mul_vln2", cycles=br["s5_mul_vln2"])
    # step 6: r <- v_stable + q*v_ln2, with one Barrett correction pass
    ap.load("R", ap.fields["A"])
    ap.add("R", "QL", "s6_sub_corr", cycles=br["s6_sub_corr"] - 2)
    need = ap.fields["R"] <= -cfg.v_ln2
    ap.fields["Q"] = np.where(need, ap.fields["Q"] + 1, ap.fields["Q"])
    ap.fields["R"] = np.where(need, ap.fields["R"] + cfg.v_ln2, ap.fields["R"])
    ap._charge("s6_sub_corr", 2)
    ap.fields["R"] = np.maximum(ap.fields["R"], -(1 << (cfg.w_vcorr - 1)))

    # steps 7-9: polynomial (r + v_b)^2 + v_c
    ap.add_const("R", cfg.v_b, "s7_add_vb", cycles=br["s7_add_vb"])
    ap.square("P", "R", "s8_square", cycles=br["s8_square"])
    ap.add_const("P", cfg.v_c, "s9_add_vc", cycles=br["s9_add_vc"])
    ap.fields["P"] = np.minimum(ap.fields["P"], (1 << cfg.w_poly) - 1)

    # step 10: v_approx <- P << (F - q)   (variable bit-serial shift)
    ap.load("VA", ap.fields["P"])
    ap.fields["Q"] = np.minimum(ap.fields["Q"], 31 + cfg.exp_shift)
    ap.shift_var("VA", "Q", cfg.q_max, "s10_varshift_q",
                 left_bias=cfg.exp_shift, cycles=br["s10_varshift_q"])
    ap.saturate("VA", cfg.w_vapprox)
    if mask is not None:
        ap.where_mask("VA", mask, 0, "mask_register")

    # step 11: saturating row-pair reduction (one total per row)
    total = ap.reduce_saturating("VA", cfg.sum_saturation, "s11_reduction",
                                 cycles=br["s11_reduction"])
    total = np.maximum(total, 1)

    # step 12: fixed-point division into the R column (per-row denominator)
    ap.divide_by_scalar("OUT", "VA", total, cfg.P_out, "s12_division",
                        incam=incam_division, cycles=br["s12_division"])
    ap._charge("s13_writeback", 2 * cfg.M)
    return ap.read("OUT"), ap


def ap_softmax_vector(v_codes: np.ndarray, cfg: PrecisionConfig,
                      mask: Optional[np.ndarray] = None,
                      incam_division: bool = False):
    """One softmax vector (v_codes: int codes at scale S, any sign) through
    the 13-step Fig.-5 program. Returns (prob_codes, APSim with cycle log)."""
    m = None if mask is None else np.asarray(mask, bool)[None]
    out, ap = ap_softmax_batch(np.asarray(v_codes, np.int64)[None], cfg,
                               mask=m, incam_division=incam_division)
    return out[0], ap


def ap_softmax_rows(v_rows: np.ndarray, cfg: PrecisionConfig,
                    mask: Optional[np.ndarray] = None):
    """[n, L] codes -> [n, L] probability codes (+total cycles) in ONE
    vectorized AP pass — no Python per-row loop. Cycles price the sequential
    single-AP schedule (rows run back-to-back on one AP): per-row program
    cycles × n, identical to running each row separately."""
    v = np.asarray(v_rows, np.int64)
    out, ap = ap_softmax_batch(v, cfg, mask=mask)
    return out, ap.cycles * v.shape[0]
