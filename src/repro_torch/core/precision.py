"""Mixed-precision configuration for the integer-only Softmax (SoftmAP Table I).

The paper's precision space is spanned by three knobs:

* ``M``      — input bit-width of the quantized scores (4, 6, 8 in the paper).
* ``N``      — *additional* bits provisioned for the sum accumulator beyond the
               ``v_approx`` width. ``N = log2(SeqLen/2)`` reproduces "no truncation".
* ``v_corr`` — width of the Barrett remainder column: ``M + e`` with e in {0, 1, 2}
               (the paper's "v_corr = M / M+1 / M+2" columns).

Derived quantities (all computable offline, exactly as the paper notes):

* ``S``      — scale. Input scores are clipped to ``[T_C, 0]`` after max-subtraction
               and quantized with a signed M-bit grid: ``S = -T_C / 2^(M-1)``.
               This is the unique reading consistent with Table I: it yields
               ``v_ln2 = floor(ln2/S) = 12`` for (M=8, T_C=-7), which fits the
               table's 4-bit ``v_ln2`` column (the naive ``S = -T_C/(2^M-1)``
               would give 25, which does not).
* ``v_ln2``  — ``floor(ln2 / S)``          (Alg. 1 line 5)
* ``mu``     — ``floor(2^(2M) / v_ln2)``   (Barrett precompute, line 6)
* ``v_b``    — ``floor(b / S)``            (line 9)
* ``v_c``    — ``floor(c / (a S^2))``      (line 10)

Bit-width accounting (Table I, verified against every cell of the table):

* ``w_poly    = 2(M + e) + 3``   — ``(v_corr + v_b)^2 + v_c`` column
* ``w_vapprox = M + 6 + 2e``     — after the ``>> q`` scaling
* ``w_sum     = w_vapprox + N``  — the saturating sum accumulator
"""

from __future__ import annotations

import dataclasses
import math

# Second-order polynomial coefficients for e^r on r in (-ln2, 0]
# (I-BERT, Kim et al. 2021 — Alg. 1 line 8).
POLY_A = 0.3585
POLY_B = 1.353
POLY_C = 0.344

LN2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """One point in SoftmAP's mixed-precision space (Table I)."""

    M: int = 6                 # input score bit-width
    N: int = 16                # extra accumulator bits for the sum
    v_corr_extra: int = 0      # e: v_corr column width = M + e, e in {0, 1, 2}
    T_C: float = -7.0          # clipping threshold for stabilized scores
    # Fractional bits of the emitted probability codes. None -> 2M + 12, the
    # paper's R-column width ("this big precision is required in the last step
    # to store the final result"). Probabilities are < 1, so the R column is
    # all fraction.
    P_out_override: int = None

    def __post_init__(self) -> None:
        if self.M < 2:
            raise ValueError(f"M={self.M} too small (need >= 2 bits)")
        if self.v_corr_extra not in (0, 1, 2):
            raise ValueError(f"v_corr_extra must be 0/1/2, got {self.v_corr_extra}")
        if self.T_C >= 0:
            raise ValueError(f"T_C must be negative, got {self.T_C}")
        if self.N < 0:
            raise ValueError(f"N must be >= 0, got {self.N}")
        if self.S >= LN2:
            # v_ln2 would floor to 0 and the Barrett range reduction degenerates.
            # The paper's M=4 @ T_C=-4 sits at S=0.5 (v_ln2=1), the edge of useful.
            if math.floor(LN2 / self.S) < 1:
                raise ValueError(
                    f"scale S={self.S:.4f} >= ln2: range reduction degenerates; "
                    "use a larger M or smaller |T_C|"
                )
        if self.P_out > 30:
            raise ValueError(f"P_out={self.P_out} exceeds int32 headroom")

    @property
    def P_out(self) -> int:
        return (2 * self.M + 12) if self.P_out_override is None else self.P_out_override

    # ---- derived scales / constants (all offline-computable, Alg. 1 l.5-10) ----

    @property
    def S(self) -> float:
        """Quantization scale: signed M-bit grid over [T_C, 0]."""
        return -self.T_C / float(2 ** (self.M - 1))

    @property
    def v_ln2(self) -> int:
        return max(1, int(math.floor(LN2 / self.S)))

    @property
    def mu(self) -> int:
        """Barrett reduction constant floor(2^(2M) / v_ln2)."""
        return int(math.floor(float(2 ** (2 * self.M)) / self.v_ln2))

    @property
    def v_b(self) -> int:
        return int(math.floor(POLY_B / self.S))

    @property
    def v_c(self) -> int:
        return int(math.floor(POLY_C / (POLY_A * self.S * self.S)))

    @property
    def poly_max(self) -> int:
        """Largest polynomial value: attained at r = 0 -> v_b^2 + v_c."""
        return self.v_b * self.v_b + self.v_c

    @property
    def exp_shift(self) -> int:
        """F: the exp codes are ``poly << (F - q)`` so that the q=0 code exactly
        fills the Table-I v_approx width (M+6+2e bits). This is I-BERT's
        ``poly * 2^(n-q)`` fixed-point scheme; without it, ``poly >> q``
        annihilates every score below ~ -2 (poly spans only ~log2(poly_max)
        bits). Verified against every Table-I v_approx cell:
        bit_length(poly_max) + F == M + 6 + 2e for all (M, e)."""
        return max(0, self.w_vapprox - self.poly_max.bit_length())

    @property
    def exp_scale(self) -> float:
        """Scale of v_approx: v_approx * exp_scale ~= e^(v_stable * S)."""
        return POLY_A * self.S * self.S / float(2**self.exp_shift)

    @property
    def q_max(self) -> int:
        """Largest Barrett quotient: scores span at most 2^(M-1) codes."""
        return (2 ** (self.M - 1)) // self.v_ln2 + 1

    # ---- Table I column widths -------------------------------------------------

    @property
    def w_v(self) -> int:
        return self.M

    @property
    def w_vstable(self) -> int:
        return self.M

    @property
    def w_vln2(self) -> int:
        return max(4, self.v_ln2.bit_length())

    @property
    def w_vb(self) -> int:
        return max(self.M, self.v_b.bit_length())

    @property
    def w_vc(self) -> int:
        return max(2 * self.M, self.v_c.bit_length())

    @property
    def w_vcorr(self) -> int:
        return self.M + self.v_corr_extra

    @property
    def w_poly(self) -> int:
        return 2 * (self.M + self.v_corr_extra) + 3

    @property
    def w_vapprox(self) -> int:
        return self.M + 6 + 2 * self.v_corr_extra

    @property
    def w_sum(self) -> int:
        return self.w_vapprox + self.N

    @property
    def w_result(self) -> int:
        """The AP's "R" column: 2M + 12 bits (paper, Sec. III)."""
        return 2 * self.M + 12

    @property
    def sum_saturation(self) -> int:
        """Saturation value of the N-truncated sum accumulator.

        The accumulator holds ``w_sum`` bits; we additionally cap at 2^30 - 1 so
        the pairwise saturating reduction never overflows int32. For every
        Table-I configuration with w_sum >= 31 the cap is unreachable on real
        attention rows (v_approx <= ~2^10 * rows), so semantics are preserved.
        """
        return min(2 ** self.w_sum - 1, 2 ** 30 - 1)

    def table1_widths(self) -> dict:
        """All Table-I column widths, for the AP cost model."""
        return {
            "v": self.w_v,
            "v_stable": self.w_vstable,
            "v_ln2": self.w_vln2,
            "v_b": self.w_vb,
            "v_c": self.w_vc,
            "v_corr": self.w_vcorr,
            "poly": self.w_poly,
            "v_approx": self.w_vapprox,
            "sum": self.w_sum,
            "result": self.w_result,
        }

    def describe(self) -> str:
        return (
            f"PrecisionConfig(M={self.M}, N={self.N}, v_corr=M+{self.v_corr_extra}, "
            f"T_C={self.T_C}, S={self.S:.5f}, v_ln2={self.v_ln2}, mu={self.mu}, "
            f"v_b={self.v_b}, v_c={self.v_c})"
        )


# The combination the paper selects as best (Sec. V-A): v_corr = M, M = 6, N = 16.
BEST = PrecisionConfig(M=6, N=16, v_corr_extra=0, T_C=-7.0)

# The paper's full sweep grid (Tables III/IV), M=4 uses T_C=-4 (Sec. V-A).
def paper_sweep_grid():
    grid = []
    for M in (4, 6, 8):
        t_c = -4.0 if M == 4 else -7.0
        for N in (8, 12, 16, 20):
            for e in (0, 1, 2):
                grid.append(PrecisionConfig(M=M, N=N, v_corr_extra=e, T_C=t_c))
    return grid
