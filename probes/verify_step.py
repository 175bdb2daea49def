"""Which op of a full-width decode step gives a speculative verify block's
row other bits than the decode step at the same position? What
``probes/verify_rows.py`` measures product by product, here inside the
model's own step, op by op.

    python3 probes/verify_step.py
    python3 probes/verify_step.py --arch dbrx-132b --layers 4 --embed-std 1
    python3 probes/verify_step.py --arch deepseek-v2-236b --layers 4
    python3 probes/verify_step.py --arch hymba-1.5b
    python3 probes/verify_step.py --slots 16 --step-rows 128 256 --rule-only

Full-width olmo-1b (or ``--arch``, at ``--layers`` layers; seeded random
bf16 weights, softmax ``int_pallas_paged``: paged decode and verify through
K2, or K4 for MLA, as phase 14 serves them) with 8 slots
holding 64-token prompts. One ``Model.verify_step`` over a block of 5
tokens a slot, then the same tokens through 5 ``Model.decode_step`` calls
from the same cache. Every norm, dense product, activation, K2 call and
the head is recorded in call order (the two runs make the same calls); the
lines give, for each op name, how many of its calls give the block's rows
bitwise equal to the decode steps' and the first call that does not. Run
with the step's padding as the model sets it on the card
(``Model.step_ctx``: the down projection and the norms at
``model.STEP_MIN_ROWS`` rows), with the down projection padded and the
norms not, and without padding (``step_ctx = ctx``), each op by op and
then as the serve runs the steps: each a CUDA-graph replay
(``serving.graphs.StepGraph``), where only the logits are compared. For an
MoE architecture the MoE layer's router product and output are recorded
too (``moe.dense_apply``, ``moe_apply``; ``Model.step_ctx`` pads every
dense product of an MoE model's step; the expert products run at their
own [E, 32, d]), a fourth run pads only what the dense
family pads (the down projection and the norms), and each run first counts the
verify block's dropped assignments (``moe._route``): a block whose slot
sends all its tokens to one expert past the capacity of 4 drops one, which
a decode step never does, so its rows differ by the reference's semantics,
not by rounding; the block's tokens are drawn again (up to 32 draws, the
count printed) until the block drops nothing. For the SSM and hybrid
families (``--arch mamba2-780m``, ``--arch hymba-1.5b``) the verify block
runs the SSM heads and the window layers' ring attention one token at a
time (``ssm_verify``, ``attn_verify_ring``): those are recorded as one op
each (``ssm``, ``ring_attn``: the block's [B, T, d] against each decode
step's [B, 1, d]) and the calls inside them are not; the hybrid's global
layers page through K2 as the serve's do; ``Model.step_ctx`` pads a
hybrid step's head as well, and a fourth run pads every dense product
(the rule before). Every graphed run also times one replay of the verify
block and of the decode step (CUDA events, median of 20), so the rules
compare within one process. ``--slots`` and ``--t`` set the block (8
slots x 5 tokens by default); ``--step-rows N ...`` runs the model's rule
again with the step padding at N rows instead of ``STEP_MIN_ROWS``, and
``--rule-only`` leaves out the runs with less padding than the rule. Then
the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

S, T, P, BS = 8, 5, 64, 16   # slots and block tokens: set by --slots / --t


class Recorder:
    """Wraps the model's ops where the model looks them up, recording each
    call's output (the first tensor of a tuple) under the op's name."""

    def __init__(self):
        from repro_torch.kernels.paged_attention import ops
        from repro_torch.models import (
            attention, hybrid, layers, mla, model, moe, ssm, transformer,
        )

        self.calls = []
        self.patches = []
        self.drops = 0
        self.inner = False
        for mod, names in ((layers, ("dense_apply", "norm_apply")),
                           (attention, ("dense_apply",)), (mla, ("dense_apply", "norm_apply")),
                           (transformer, ("dense_apply", "norm_apply", "moe_apply")),
                           (model, ("dense_apply", "norm_apply", "embed_logits")),
                           (moe, ("dense_apply",)), (hybrid, ("norm_apply",)),
                           (ops, ("paged_attend_dense", "paged_attend_mla"))):
            for name in names:
                self._wrap(mod, name, name)
        # the per-token recurrences: one op each, their inner calls unrecorded
        for mod, name, label in ((transformer, "ssm_decode", "ssm"),
                                 (transformer, "ssm_verify", "ssm"),
                                 (hybrid, "ssm_decode", "ssm"), (hybrid, "ssm_verify", "ssm"),
                                 (hybrid, "attn_decode_ring", "ring_attn"),
                                 (hybrid, "attn_verify_ring", "ring_attn")):
            self._wrap(mod, name, label, scope=True)
        self._wrap(layers._ACTS, "silu", "silu", item=True)
        route = moe._route

        def counted_route(p, x, cfg, ctx):
            out = route(p, x, cfg, ctx)
            if self.on:
                c, target = out[0], out[1]
                self.drops += int((target == cfg.n_experts * c).sum())
            return out

        moe._route = counted_route
        self.patches.append((moe, "_route", route, False))

    def _wrap(self, owner, attr, label, item=False, scope=False):
        orig = owner[attr] if item else getattr(owner, attr)

        def recorded(*args, **kw):
            outer = not self.inner
            if scope:
                self.inner = True
            try:
                out = orig(*args, **kw)
            finally:
                if scope and outer:
                    self.inner = False
            x = out[0] if isinstance(out, tuple) else out
            # the model's [B, T, ...] (not a padded inner call, nor an MoE
            # layer's expert activations [E, B * C, f], nor a call inside
            # a per-token recurrence)
            if self.on and outer and x.dim() >= 3 and x.shape[0] == S:
                self.calls.append((label, x.clone()))
            return out

        if item:
            owner[attr] = recorded
        else:
            setattr(owner, attr, recorded)
        self.patches.append((owner, attr, orig, item))

    on = False

    def run(self, fn):
        self.calls, self.on = [], True
        try:
            fn()
        finally:
            self.on = False
        return self.calls

    def restore(self):
        for owner, attr, orig, item in reversed(self.patches):
            if item:
                owner[attr] = orig
            else:
                setattr(owner, attr, orig)


def _clone(cache):
    from repro_torch.models.kv_cache import tree_map
    return tree_map(lambda v: v.clone(), cache)


def compare(label, model, params, cache, tokens, pos, rec):
    """The verify block against T decode steps from copies of ``cache``."""
    staged = _clone(cache)
    rec.drops = 0
    verify = rec.run(lambda: model.verify_step(params, staged, {"token": tokens}, pos))
    drops = rec.drops
    steps = []
    stepped = _clone(cache)
    for t in range(T):
        steps.append(rec.run(lambda t=t: model.decode_step(
            params, stepped, {"token": tokens[:, t:t + 1]}, pos + t)))
    assert all(len(s) == len(verify) for s in steps), "the runs made different calls"
    by_op = {}
    for i, (name, out) in enumerate(verify):
        ok = all(torch.equal(out[:, t], steps[t][i][1][:, 0]) for t in range(T))
        seen = by_op.setdefault(name, {"calls": 0, "equal": 0, "first_differing_call": None})
        seen["calls"] += 1
        seen["equal"] += ok
        if not ok and seen["first_differing_call"] is None:
            seen["first_differing_call"] = i
    first = min((v["first_differing_call"] for v in by_op.values()
                 if v["first_differing_call"] is not None), default=None)
    print(f"{label}, op by op: {len(verify)} recorded calls, {drops} dropped assignments in "
          f"the verify block; by op {by_op}; first differing call {first}"
          f"{'' if first is None else ' (' + verify[first][0] + ')'}", flush=True)
    equal, verify_ms, decode_ms = graphed(model, params, cache, tokens, pos)
    print(f"{label}, graphed: logit rows of the replayed verify block bitwise equal to the "
          f"replayed decode steps': {equal}; one replay {verify_ms:.4f} ms (verify block) and "
          f"{decode_ms:.4f} ms (decode step)", flush=True)


def replay_ms(graph, reps=20):
    """Median device ms of one replay of ``graph`` over ``reps`` replays
    (CUDA events around each)."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graphed(model, params, cache, tokens, pos):
    """The verify step and the decode step each captured once and replayed
    (the warm-up run first, as the serve's ``StepGraph``): whether the
    block's logits equal T decode steps', and the ms of one replay of
    each (``replay_ms``, after the comparison)."""
    from repro_torch.models.kv_cache import tree_leaves
    from repro_torch.serving.graphs import StepGraph

    def restore(dst):
        # the warm-up step advanced a recurrent state in place
        for a, b in zip(tree_leaves(dst), tree_leaves(cache)):
            a.copy_(b)

    cache_v = _clone(cache)
    tok_v, pos_v = tokens.clone(), pos.clone()
    verify = StepGraph(lambda: model.verify_step(params, cache_v, {"token": tok_v}, pos_v)[0],
                       tree_leaves(cache_v) + [tok_v, pos_v])
    verify()
    restore(cache_v)
    block = verify().clone()
    cache_d = _clone(cache)
    tok_d, pos_d = tokens[:, :1].clone(), pos.clone()
    decode = StepGraph(lambda: model.decode_step(params, cache_d, {"token": tok_d}, pos_d)[0],
                       tree_leaves(cache_d) + [tok_d, pos_d])
    decode()
    restore(cache_d)
    rows = []
    for t in range(T):
        tok_d.copy_(tokens[:, t:t + 1])
        pos_d.copy_(pos + t)
        rows.append(decode().clone())
    equal = all(torch.equal(block[:, t], rows[t][:, 0]) for t in range(T))
    return equal, replay_ms(verify), replay_ms(decode)


def less_padding(name, cfg, model, params, cache, tokens, pos, rec):
    """The runs with less step padding than the model's rule: (MoE) the
    dense family's, (hybrid) every dense product, the norms unpadded, and
    no padding."""
    from repro_torch.models import hybrid, layers, mla, ssm, transformer
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import STEP_MIN_ROWS

    step_ctx = model.step_ctx
    if cfg.family == "moe":
        model.step_ctx = dataclasses.replace(step_ctx, min_rows=0)
        compare(f"{name}, the dense family's step padding (the down projection and "
                f"the norms at {STEP_MIN_ROWS} rows, the other products not)",
                model, params, cache, tokens, pos, rec)
    elif cfg.family == "hybrid":
        model.step_ctx = dataclasses.replace(step_ctx, min_rows=STEP_MIN_ROWS)
        compare(f"{name}, every dense product padded to {STEP_MIN_ROWS} rows (and the "
                "norms)", model, params, cache, tokens, pos, rec)
    model.step_ctx = step_ctx
    # every module's norm_apply, called with the norms' padding off
    saved = {m: m.norm_apply for m in (layers, mla, transformer, model_mod, hybrid, ssm)}
    for m, f in saved.items():
        m.norm_apply = lambda p, x, kind, ctx, eps=1e-5, f=f: f(
            p, x, kind, dataclasses.replace(ctx, step_min_rows=0), eps)
    try:
        padded = {"moe": "every dense product",
                  "hybrid": "the down projection and the head"}.get(
                      cfg.family, "the down projection")
        compare(f"{name}, {padded} padded to {STEP_MIN_ROWS} rows, the norms not",
                model, params, cache, tokens, pos, rec)
    finally:
        for m, f in saved.items():
            m.norm_apply = f
    model.step_ctx = model.ctx
    compare(f"{name}, no step padding", model, params, cache, tokens, pos, rec)


def main():
    import argparse

    ap = argparse.ArgumentParser(description="verify block vs decode steps, op by op")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: full)")
    ap.add_argument("--slots", type=int, default=8, help="slots of the block")
    ap.add_argument("--t", type=int, default=5, help="tokens a slot in the block")
    ap.add_argument("--step-rows", type=int, nargs="*", default=[],
                    help="also run the model's rule with the step padding at these rows")
    ap.add_argument("--rule-only", action="store_true",
                    help="leave out the runs with less padding than the model's rule")
    ap.add_argument("--embed-std", type=float, default=0.0,
                    help="redraw the embedding at this std (0: Model.init's 0.02); at "
                         "0.02 an MoE model's tokens of one sequence route alike")
    args = ap.parse_args()
    global S, T
    S, T = args.slots, args.t
    if not torch.cuda.is_available():
        raise SystemExit("verify_step: no CUDA device visible to torch")
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models import kv_cache
    from repro_torch.models.model import STEP_MIN_ROWS, Model

    depth = {"n_layers": args.layers} if args.layers else {}
    cfg = get_config(args.arch, softmax=SoftmaxSpec("int_pallas_paged"), **depth)
    name = f"{cfg.name} ({cfg.n_layers} layers, {S} slots x T {T})"
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    if args.embed_std:
        params["embed"]["w"].mul_(args.embed_std / 0.02)
        name += f", embedding std {args.embed_std}"
    g = torch.Generator("cuda").manual_seed(1)
    cache_len = max(128, cfg.window) if cfg.family == "hybrid" else 128
    stripes = kv_cache.cache_zeros(cfg, S, cache_len, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (S, P), generator=g, device="cuda")
    for s in range(S):
        _, c = model.prefill(params, {"tokens": prompts[s:s + 1]}, cache_len=cache_len)
        kv_cache.insert_slot(stripes, c, s)
    if cfg.family == "hybrid":
        # the global layers page through K2, the rings and SSM state stay
        stripes["full"]["attn"] = kv_cache.contiguous_as_paged(stripes["full"]["attn"], BS)
        cache = stripes
    elif cfg.family == "ssm":
        cache = stripes
    else:
        cache = kv_cache.contiguous_as_paged(stripes, BS)
    pos = torch.full((S,), P, dtype=torch.int32, device="cuda")
    rec = Recorder()
    for draws in range(1, 33):
        tokens = torch.randint(0, cfg.vocab, (S, T), generator=g, device="cuda")
        if cfg.family != "moe":
            break
        rec.drops = 0
        with torch.no_grad():
            rec.run(lambda: model.verify_step(params, _clone(cache), {"token": tokens}, pos))
        if rec.drops == 0:
            break
    print(f"{name}: verify block drawn {draws} time(s); it drops {rec.drops} assignments",
          flush=True)
    try:
        with torch.no_grad():
            compare(f"{name}, step padding to {STEP_MIN_ROWS} rows (Model.step_ctx)", model,
                    params, cache, tokens, pos, rec)
            step_ctx = model.step_ctx
            for rows in args.step_rows:
                model.step_ctx = dataclasses.replace(
                    step_ctx, step_min_rows=rows,
                    min_rows=rows if step_ctx.min_rows else 0)
                compare(f"{name}, the model's rule at {rows} rows", model, params, cache,
                        tokens, pos, rec)
            model.step_ctx = step_ctx
            if not args.rule_only:
                less_padding(name, cfg, model, params, cache, tokens, pos, rec)
    finally:
        rec.restore()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
