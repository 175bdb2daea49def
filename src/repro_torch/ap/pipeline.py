"""End-to-end SoftmAP evaluation pipeline: AP vs GPU energy / latency / EDP
for the paper's Llama2 workloads (Figs. 6-8, Tables V-VI, area numbers; a
copy of ``src/repro/ap/pipeline.py``).

The AP side is priced through the softmax execution-backend registry
(``repro_torch.backends``): the same ``meter`` that serves per-request cost
telemetry in ``serving.engine`` produces the paper-figure numbers here, so
benchmarks and serving can never drift apart. ``cost_model`` is reached only
through the backend. The GPU side is ``ap.gpu_model``'s analytic A100 and
RTX3090 baselines (the paper's), computed in Python: no device runs."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.ap import gpu_model as gm
from repro_torch.backends import get_backend
from repro_torch.core.precision import BEST, PrecisionConfig

# Llama2 attention geometry (q heads define softmax rows; Sec. IV)
LLAMA_SPECS = {
    "llama2-7b": {"heads": 32, "layers": 32, "params": 6.74e9, "d_model": 4096},
    "llama2-13b": {"heads": 40, "layers": 40, "params": 13.0e9, "d_model": 5120},
    "llama2-70b": {"heads": 64, "layers": 80, "params": 69.0e9, "d_model": 8192},
}

AREA_SEQ = 4096  # APs are provisioned for the paper's max sequence length

SEQ_LENS = (128, 256, 512, 1024, 2048, 4096)
BATCHES = (1, 2, 4, 8, 16, 32)

# Any integer-family backend meters identically (they share the Table-II
# model); ap_sim is the canonical "this is the hardware" choice.
AP_BACKEND = "ap_sim"


def compare_point(model: str, seq_len: int, batch: int,
                  cfg: PrecisionConfig = BEST) -> Dict:
    """One (model, L, B) cell: per-layer softmax cost on AP vs both GPUs."""
    spec = LLAMA_SPECS[model]
    h = spec["heads"]
    backend = get_backend(AP_BACKEND, cfg)
    # full prefill attention matrix: batch x heads x seq_len rows of seq_len
    ap = backend.meter((batch, h, seq_len, seq_len), heads=h)
    area = h * backend.design(AREA_SEQ).area_mm2
    out = {"model": model, "seq_len": seq_len, "batch": batch,
           "ap_latency_s": ap.latency_s, "ap_energy_j": ap.energy_j,
           "ap_cycles": ap.cycles, "ap_area_mm2": area}
    for g in (gm.A100, gm.RTX3090):
        c = gm.softmax_cost(g, batch, h, seq_len, seq_len)
        k = g.name.lower()
        out[f"{k}_latency_s"] = c["latency_s"]
        out[f"{k}_energy_j"] = c["energy_j"]
        out[f"{k}_energy_ratio"] = c["energy_j"] / ap.energy_j
        out[f"{k}_latency_ratio"] = c["latency_s"] / ap.latency_s
        out[f"{k}_edp_ratio"] = (c["energy_j"] * c["latency_s"]) / ap.edp
    return out


def sweep(model: str, cfg: PrecisionConfig = BEST) -> List[Dict]:
    return [compare_point(model, l, b, cfg)
            for l in SEQ_LENS for b in BATCHES]


def summarize(model: str, cfg: PrecisionConfig = BEST) -> Dict:
    """The paper's headline numbers for one model: max/avg energy savings,
    latency ratio range at L>=1024, max EDP ratios, area."""
    rows = sweep(model, cfg)
    e_a100 = [r["a100_energy_ratio"] for r in rows]
    e_3090 = [r["rtx3090_energy_ratio"] for r in rows]
    long_rows = [r for r in rows if r["seq_len"] >= 1024]
    return {
        "model": model,
        "max_energy_ratio_a100": max(e_a100),
        "avg_energy_ratio_a100": sum(e_a100) / len(e_a100),
        "max_energy_ratio_rtx3090": max(e_3090),
        "avg_energy_ratio_rtx3090": sum(e_3090) / len(e_3090),
        "latency_ratio_a100_long": (
            min(r["a100_latency_ratio"] for r in long_rows),
            max(r["a100_latency_ratio"] for r in long_rows)),
        "latency_ratio_rtx3090_long": (
            min(r["rtx3090_latency_ratio"] for r in long_rows),
            max(r["rtx3090_latency_ratio"] for r in long_rows)),
        "max_edp_ratio_a100": max(r["a100_edp_ratio"] for r in rows),
        "max_edp_ratio_rtx3090": max(r["rtx3090_edp_ratio"] for r in rows),
        "min_edp_ratio_a100": min(r["a100_edp_ratio"] for r in rows),
        "area_mm2": rows[0]["ap_area_mm2"],
        "crossover_seq": _crossover(rows),
    }


def _crossover(rows) -> int:
    """Smallest seq_len where the AP is at least latency-parity with A100
    across all batches."""
    for l in SEQ_LENS:
        sub = [r for r in rows if r["seq_len"] == l]
        if all(r["a100_latency_ratio"] >= 1.0 for r in sub):
            return l
    return -1


def energy_per_op_pj(cfg: PrecisionConfig = BEST, seq_len: int = 4096) -> float:
    """Table VI metric: softmax energy / elementary word-ops (13 dataflow steps
    per word)."""
    rep = get_backend(AP_BACKEND, cfg).meter((1, seq_len))
    word_ops = seq_len * 13
    return rep.energy_j / word_ops * 1e12


def energy_per_cell_cycle_pj(cfg: PrecisionConfig = BEST) -> float:
    """The 16 nm per-cell-per-cycle energy the backend's meter is built on."""
    return get_backend(AP_BACKEND, cfg).cell_energy_fj * 1e-3


def fig1_softmax_fraction(seq_lens=(128, 512, 1024, 2048, 4096, 8192, 16384),
                          model: str = "llama2-7b", batch: int = 1) -> Dict:
    """Softmax share of whole-forward runtime on A100 (paper Fig. 1). Uses the
    fused-kernel softmax variant: Fig. 1 profiles the F.softmax op itself."""
    spec = LLAMA_SPECS[model]
    out = {}
    for l in seq_lens:
        sm = gm.softmax_cost(gm.A100, batch, spec["heads"], l, l, fused=True)
        sm_total = sm["latency_s"] * spec["layers"]
        gemm = gm.model_forward_cost(gm.A100, spec["params"], batch, l,
                                     spec["layers"], spec["d_model"])
        out[l] = sm_total / (sm_total + gemm)
    return out
