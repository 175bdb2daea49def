"""Perf hillclimb: hypothesis -> change -> re-count -> measure (port
of ``src/repro/launch/hillclimb.py``), every variant through the dry run's
``run_cell`` on the meta device.

The reference's variants for its three cells, with their hypotheses as it
wrote them for XLA on the TPU mesh:

  deepseek-v2-236b x train_4k    worst roofline fraction of the big cells
  dbrx-132b x prefill_32k        the collective-bound cell
  qwen2.5-32b x prefill_32k      paper-representative (32k attention softmax)

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --mesh card
    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell N] [--only NAME]

``--mesh card`` counts every variant for one H100; on ``single`` (the
default, as the reference's) a cell the port cannot shard prints its skip.
A variant the port runs with the same code as another says so beside its
numbers: the MoE dispatch variant ``moe_impl="scatter_combine"`` is the
gather code (``"expert_tp"`` too on one card; on a model axis it splits
every expert's hidden), sharding rule overrides place nothing on one card,
and bf16 parameters are the port's serving weights already. ``"a2a"``
runs its own code (``models/moe.py``: capacity per token segment) and is
counted as any variant. A variant whose counts equal an earlier one's names it,
so no delta of zero goes unexplained. Each variant's result lands in
``<out>/<mesh>/<arch>__<shape>__<name>.json``; every run counts afresh
(a cell takes seconds) and never reads a result back.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core.softmax_variants import SoftmaxSpec
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.specs import SHAPES, Skip

# (cell, variant_name, hypothesis, run_cell kwargs)
PLAN = [
    # ---- cell A: deepseek-v2-236b x train_4k ------------------------------
    ("deepseek-v2-236b", "train_4k", "baseline",
     "paper-faithful baseline (gather-MoE, fp32 master, full remat)", {}),
    ("deepseek-v2-236b", "train_4k", "moe_scatter_combine",
     "MoE dispatch crossing (data->experts) sharding forces GSPMD to "
     "replicate E*C*d buffers via all-reduce (~5 GB/layer). Local dispatch + "
     "E-local combine needs ONE [B,S,d] AR/layer: predict collective "
     "47s -> ~15s, memory -20%.",
     {"cfg_overrides": {"moe_impl": "scatter_combine"}}),
    ("deepseek-v2-236b", "train_4k", "sc+logits_bf16",
     "vocab-102400 f32 logits + their bwd are ~7%% of bytes; bf16 halves "
     "them (CE still reduces in f32): predict memory -3%.",
     {"cfg_overrides": {"moe_impl": "scatter_combine",
                        "logits_dtype": "bfloat16"}}),
    ("deepseek-v2-236b", "train_4k", "sc+bf16+gradcomp",
     "bf16 gradient all-reduce with error feedback halves the cross-DP "
     "gradient payload (~59 GB/dev fp32): predict collective -1..2s.",
     {"cfg_overrides": {"moe_impl": "scatter_combine",
                        "logits_dtype": "bfloat16"},
      "grad_compress": True}),
    ("deepseek-v2-236b", "train_4k", "sc+bf16+remat_dots",
     "remat 'dots' keeps matmul outputs (no recompute of the expensive "
     "einsums in bwd): predict compute -25%, memory term down, peak mem UP.",
     {"cfg_overrides": {"moe_impl": "scatter_combine",
                        "logits_dtype": "bfloat16"},
      "remat": "dots"}),

    # ---- cell B: dbrx-132b x prefill_32k ----------------------------------
    ("dbrx-132b", "prefill_32k", "baseline",
     "paper-faithful baseline", {}),
    ("dbrx-132b", "prefill_32k", "moe_scatter_combine",
     "same dispatch fix as cell A: the 308 GiB/dev of all-reduce is the "
     "capacity-buffer replication: predict collective 8.2s -> <2s.",
     {"cfg_overrides": {"moe_impl": "scatter_combine"}}),
    ("dbrx-132b", "prefill_32k", "sc+bf16_params",
     "serving weights in bf16 halve the per-layer expert-weight all-gather "
     "(fp32 ZeRO-R gathers dominate what remains): predict all-gather bytes "
     "-50%, memory -15%.",
     {"cfg_overrides": {"moe_impl": "scatter_combine"},
      "params_dtype": torch.bfloat16}),
    ("dbrx-132b", "prefill_32k", "sc+bf16+cf1.0",
     "capacity factor 1.25 -> 1.0 shrinks every expert buffer 20%: predict "
     "memory -10% at the cost of more token drops (quality knob, serving "
     "operators choose).",
     {"cfg_overrides": {"moe_impl": "scatter_combine",
                        "capacity_factor": 1.0},
      "params_dtype": torch.bfloat16}),

    # ---- cell C: qwen2.5-32b x prefill_32k --------------------------------
    ("qwen2.5-32b", "prefill_32k", "baseline",
     "paper-faithful baseline", {}),
    ("qwen2.5-32b", "prefill_32k", "bf16_params",
     "fp32 weights are gathered over the data axis every layer (ZeRO-R); "
     "bf16 halves that traffic: predict all-gather -50%, memory -20%.",
     {"params_dtype": torch.bfloat16}),
    ("qwen2.5-32b", "prefill_32k", "bf16+replicate_params",
     "32B bf16 fits replicated across data (4.1 GB/dev TP-sharded): kill "
     "the param all-gathers entirely: predict collective -0.3s, memory down.",
     {"params_dtype": torch.bfloat16,
      "rules_overrides": (("embed", None),)}),
    ("qwen2.5-32b", "prefill_32k", "bf16+repl+kv_replicate",
     "kv=8 heads on a 16-way model axis pads to 16 and triggers GSPMD "
     "'involuntary full rematerialization' copies; computing KV replicated "
     "(flops negligible) removes them: predict all-reduce down, memory -5%.",
     {"params_dtype": torch.bfloat16,
      "rules_overrides": (("embed", None), ("kv_heads", None))}),
    ("qwen2.5-32b", "prefill_32k", "bf16+repl+kv+chunk8k",
     "attn q-chunk 2048 -> 8192 quarters the chunk-boundary writes of the "
     "[blk,32k] score tiles: predict memory -5%, no collective change.",
     {"params_dtype": torch.bfloat16,
      "rules_overrides": (("embed", None), ("kv_heads", None)),
      "cfg_overrides": {"attn_chunk": 8192}}),
]


# ---- round 2: informed by round-1 refutations (see EXPERIMENTS.md §Perf) ---
PLAN += [
    ("dbrx-132b", "prefill_32k", "expert_tp",
     "REVISED after scatter_combine REGRESSED (+65% coll): any scheme that "
     "moves the [E,C,d] capacity buffer across shards pays ~buf*layers. "
     "Expert-TP shards every expert's d_ff over model instead (f=10752 TPs "
     "well): dispatch+combine fully local, ONE [B,S,d] AR/layer: predict "
     "collective 8.2s -> <1.5s.",
     {"cfg_overrides": {"moe_impl": "expert_tp"}}),
    ("dbrx-132b", "prefill_32k", "etp+bf16_params",
     "expert-TP + bf16 serving weights (halve the remaining weight gathers).",
     {"cfg_overrides": {"moe_impl": "expert_tp"},
      "params_dtype": torch.bfloat16}),
    ("qwen2.5-32b", "prefill_32k", "scores_bf16",
     "REVISED after param-side variants moved nothing: the terms are "
     "dominated by the f32 score/softmax tensors of 32k attention (the "
     "paper's Fig.-1 regime!). Keep scores in bf16 with f32-accumulated "
     "softmax sum: predict memory -30%+.",
     {"cfg_overrides": {"scores_dtype": "bfloat16"},
      "softmax": SoftmaxSpec("fp_lowp")}),
    ("qwen2.5-32b", "prefill_32k", "scores_bf16+chunk8k",
     "on top of scores_bf16: q-chunk 2048 -> 8192 (fewer scan-boundary "
     "writes): predict memory -5%.",
     {"cfg_overrides": {"scores_dtype": "bfloat16", "attn_chunk": 8192},
      "softmax": SoftmaxSpec("fp_lowp")}),
    ("deepseek-v2-236b", "train_4k", "expert_tp",
     "expert-TP for the fine-grained case too: f/16=96 under-fills the MXU "
     "on real hardware (flagged; the flop count cannot see it) but the "
     "collective prediction is the same ONE [B,S,d] AR per layer: predict "
     "collective 47s -> ~10s.",
     {"cfg_overrides": {"moe_impl": "expert_tp"}}),
    ("deepseek-v2-236b", "train_4k", "etp+bf16+gradcomp",
     "expert-TP + bf16 logits + bf16 gradient compression.",
     {"cfg_overrides": {"moe_impl": "expert_tp",
                        "logits_dtype": "bfloat16"},
      "grad_compress": True}),
]


# ---- round 3: best combinations + negative control ------------------------
PLAN += [
    ("deepseek-v2-236b", "train_4k", "best:sc+dots+cf1.0",
     "combine the two confirmed wins (scatter_combine mem -8.4%, remat_dots "
     "comp -10%/mem -12%) with capacity 1.0 (confirmed -17.5% comp on dbrx): "
     "predict mem -20%, comp -25% vs baseline.",
     {"cfg_overrides": {"moe_impl": "scatter_combine", "capacity_factor": 1.0,
                        "logits_dtype": "bfloat16"},
      "remat": "dots"}),
    ("dbrx-132b", "prefill_32k", "gather+cf1.0+bf16",
     "every dispatch restructuring regressed (XLA re-shards 'local' scatters "
     "and all-reduces); keep the baseline gather dispatch and shrink what "
     "moves: capacity 1.0 + bf16 weights: predict comp -17%, coll -15%.",
     {"cfg_overrides": {"capacity_factor": 1.0},
      "params_dtype": torch.bfloat16}),
    ("qwen2.5-32b", "prefill_32k", "no_seq_sp(negctl)",
     "negative control: drop the sequence-parallel residual constraint — "
     "expect REGRESSION (validates that the baseline SP choice is load-"
     "bearing).",
     {"rules_overrides": (("seq_sp", None),)}),
]


# ---- round 4: the all-to-all dispatch (designed in round 1-3 narratives) ---
PLAN += [
    ("deepseek-v2-236b", "train_4k", "a2a_dispatch",
     "segment-local capacity slots make the dispatch scatter shard-local; "
     "the buffer reshard (segment-sharded -> expert-sharded) is a "
     "dim-to-dim move GSPMD lowers to ALL-TO-ALL: each token activation "
     "moves once (~buf/16 per device per layer) instead of buffer-sized "
     "all-reduces: predict collective 47s -> ~15s, memory down too.",
     {"cfg_overrides": {"moe_impl": "a2a"}}),
    ("deepseek-v2-236b", "train_4k", "best2:a2a+dots+cf1.0",
     "a2a dispatch + the confirmed remat-dots + capacity-1.0 wins.",
     {"cfg_overrides": {"moe_impl": "a2a", "capacity_factor": 1.0,
                        "logits_dtype": "bfloat16"},
      "remat": "dots"}),
    ("dbrx-132b", "prefill_32k", "a2a_dispatch",
     "same a2a structure for the collective-bound prefill cell: predict "
     "collective 8.2s -> ~2s.",
     {"cfg_overrides": {"moe_impl": "a2a"}}),
    ("dbrx-132b", "prefill_32k", "a2a+cf1.0+bf16",
     "a2a + capacity 1.0 + bf16 weights (the confirmed compute win).",
     {"cfg_overrides": {"moe_impl": "a2a", "capacity_factor": 1.0},
      "params_dtype": torch.bfloat16}),
]

# moe_impl values the port runs with the gather code (models/moe.py: on one
# device they compute the same function, which the reference's tests hold;
# on a model axis "expert_tp" places and splits its experts by ``mlp``)
SAME_AS_GATHER = ("scatter_combine", "expert_tp")


def same_code(kw: dict, mesh: str, kind: str):
    """(why, the arguments it runs with) for a variant the port runs as
    another: the MoE dispatch variants as moe_impl="gather" ("expert_tp"
    on the card only), sharding rule overrides on one card as without
    them, and bf16 parameters outside training as the port's serving
    weights are already; (None, kw) otherwise."""
    why, run = [], dict(kw)
    if kind != "train" and kw.get("params_dtype") == torch.bfloat16:
        run.pop("params_dtype")
        why.append("the port's serving weights are bf16 already")
    cfg = dict(kw.get("cfg_overrides", {}))
    impl = cfg.get("moe_impl")
    if impl in SAME_AS_GATHER and (impl != "expert_tp" or mesh == "card"):
        cfg.pop("moe_impl")
        run.pop("cfg_overrides")
        if cfg:
            run["cfg_overrides"] = cfg
        why.append(f"moe_impl={impl!r} runs the gather code (models/moe.py)")
    if mesh == "card" and kw.get("rules_overrides"):
        run.pop("rules_overrides")
        why.append(f"sharding rules {kw['rules_overrides']} place nothing on one card")
    return ("; ".join(why) or None), run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=None, help="substring filter on arch")
    ap.add_argument("--only", default=None, help="substring filter on variant name")
    ap.add_argument("--mesh", default="single", choices=["card", "single", "multi"])
    ap.add_argument("--out", default="artifacts/perf")
    args = ap.parse_args(argv)
    outdir = os.path.join(args.out, args.mesh)
    os.makedirs(outdir, exist_ok=True)

    baselines, results, seen = {}, {}, {}
    for arch, shape, name, hyp, kw in PLAN:
        if args.cell and args.cell not in arch:
            continue
        if args.only and args.only not in name and name != "baseline":
            continue
        tag = f"{arch}__{shape}__{name}"
        key = (arch, shape)
        why, run_kw = same_code(kw, args.mesh, SHAPES[shape].kind)
        path = os.path.join(outdir, tag + ".json")
        res = results.get((key, _kw_key(run_kw)))
        if res is None:
            print(f"\n=== {tag}\n    hypothesis: {hyp}", flush=True)
            try:
                res = run_cell(arch, shape, args.mesh, **run_kw)
            except Skip as e:
                res = {"skipped": str(e)}
            except NotImplementedError as e:
                res = {"refused": str(e)}
            res = dict(res, variant=name, hypothesis=hyp, runs_as=why)
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
        if "skipped" in res or "refused" in res:
            what = "SKIP   " if "skipped" in res else "REFUSED"
            print(f"{tag:60s} {what} {res.get('skipped') or res.get('refused')}", flush=True)
            continue
        results[(key, _kw_key(run_kw))] = res
        if name == "baseline":
            baselines[key] = res["roofline"]
        counts = (key, res["flops_per_device"], res["bytes_per_device"],
                  res["memory"]["peak_bytes"])
        twin = seen.setdefault(counts, name)
        notes = ([f"same program as without it: {why}"] if why else []) + (
            [f"the same counts as {twin}"] if twin != name else [])
        print(f"{tag:60s} {_line(res, baselines.get(key))}"
              + "".join(f"  [{n}]" for n in notes), flush=True)


def _kw_key(kw: dict) -> str:
    return json.dumps(kw, sort_keys=True, default=str)


def _line(res: dict, base) -> str:
    r = res["roofline"]
    base = base or r

    def delta(k):
        return (r[k] - base[k]) / base[k] * 100 if base[k] else 0.0

    return (f"comp={r['compute_s']:9.3f} ({delta('compute_s'):+5.1f}%) "
            f"mem={r['memory_s']:9.3f} ({delta('memory_s'):+5.1f}%) "
            f"coll={r['collective_s']:7.3f} ({delta('collective_s'):+5.1f}%) "
            f"dom={r['dominant']} peak={(res['memory']['peak_bytes'] or 0) / 2**30:.2f}GB")


if __name__ == "__main__":
    main()
