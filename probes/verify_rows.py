"""Does a speculative verify step give a row other bits than the decode step
at the same position? What sets ``chip_smoke.py`` phase 14's spec serve ==
plain serve on the card.

    python3 probes/verify_rows.py

A serve decode step multiplies one row per slot (8 at phase 6's shape); a
verify round multiplies the K + 1 = 5 rows of every slot at once, 40 rows.
Each product below ([M, K] x [K, N], bf16, as ``layers.dense_apply``
computes it) is evaluated at 40 rows (row ``slot * 5 + t``) and, for each
t, at the 8 rows of that t alone (what the decode step at that position
multiplies); the line gives whether every row is bitwise equal, the
largest difference, the kernels each row count launches (torch.profiler)
and the device time of both products (``ms``: ten calls in one CUDA graph,
timed by CUDA events, the median of five replays). The
products are olmo-1b's seven projections and its head, and minicpm3-4b's
projections, absorbed-query and output einsums, and head.

Then, for each product whose rows differ, the two repairs: (a) the verify
block's product run as T products of the decode step's [8, K] rows, and (b)
the decode step's and the verify block's products both zero-padded to one
row count R (40, 64, 128, 256; what ``layers.dense_apply`` does under
``Ctx.min_rows``). Each line gives whether the repair makes the rows bitwise
equal, and its device time against the plain products: the extra ms a
verify round and a decode step pay for one such product. Then the step's
norms (``layers.norm_apply``: olmo-1b's non-parametric layernorm at 2048,
minicpm3-4b's rmsnorms at 2560, 768 and 256) the same way, unpadded and
padded to ``model.STEP_MIN_ROWS`` rows as decode and verify steps run them
on the card (``Model.step_ctx``). Then the card's name and power limit.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

S, T = 8, 5
PAD_ROWS = (40, 64, 128, 256)
# (K, N); a head tied to the embedding multiplies by its transpose
OLMO = {"wq/wk/wv": (2048, 2048), "wo": (2048, 2048), "gate/up": (2048, 8192),
        "down": (8192, 2048), "head (tied, x @ E^T)": (2048, 50304)}
MINICPM = {"wdq": (2560, 768), "wuq": (768, 40 * 96), "wdkv": (2560, 256),
           "wkr": (2560, 32), "wo": (40 * 64, 2560), "gate/up": (2560, 6400),
           "down": (6400, 2560), "head": (2560, 73448)}


def ms(fn, calls=10, reps=5):
    """Device ms of one ``fn()``: ``calls`` calls captured in one CUDA graph
    (no host time between them), the median of ``reps`` replays over
    ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)


def kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events() if e.device_type == DeviceType.CUDA})


def compare(label, verify_fn, decode_fn):
    """``verify_fn()`` -> [S * T, N] rows; ``decode_fn(t)`` -> [S, N] rows of
    block entry t."""
    whole = verify_fn()
    diffs = []
    for t in range(T):
        d = (whole[t::T].float() - decode_fn(t).float()).abs().max().item()
        diffs.append(d)
    equal = all(d == 0 for d in diffs)
    print(f"  {label}: rows bitwise equal at {S * T} and {S} rows: {equal} (largest "
          f"difference by entry {[round(d, 6) for d in diffs]}); kernels at {S * T} rows "
          f"{kernels(verify_fn)}, at {S} rows {kernels(lambda: decode_fn(0))}; "
          f"{ms(verify_fn):.4f} ms at {S * T} rows, {ms(lambda: decode_fn(0)):.4f} ms at "
          f"{S} rows", flush=True)
    return equal


def padded(x, w, rows):
    """``x @ w`` with x zero-padded to ``rows`` rows, as ``dense_apply``."""
    return (F.pad(x, (0, 0, 0, rows - x.shape[0])) @ w)[:x.shape[0]]


def repairs(label, x, w):
    """The two repairs of a product whose verify rows differ: (a) T products
    of the decode step's rows, (b) both sides padded to one row count."""
    rows_t = [x[t::T].contiguous() for t in range(T)]
    decode = [r @ w for r in rows_t]
    t_plain_v, t_plain_d = ms(lambda: x @ w), ms(lambda: rows_t[0] @ w)
    by_t = lambda: torch.stack([r @ w for r in rows_t], 1).reshape(S * T, -1)  # noqa: E731
    eq = torch.equal(by_t(), torch.stack(decode, 1).reshape(S * T, -1))
    t_a = ms(by_t)
    print(f"    (a) {T} products of [{S}, K]: rows bitwise equal {eq}; a verify round "
          f"{t_a:.4f} ms against {t_plain_v:.4f} ms (+{t_a - t_plain_v:.4f} ms), a decode "
          f"step unchanged", flush=True)
    out = {"a": {"equal": eq, "round_ms": t_a - t_plain_v, "step_ms": 0.0}}
    for rows in PAD_ROWS:
        eq = all(torch.equal(padded(x, w, rows)[t::T], padded(rows_t[t], w, rows))
                 for t in range(T))
        t_v, t_d = ms(lambda: padded(x, w, rows)), ms(lambda: padded(rows_t[0], w, rows))
        print(f"    (b) both padded to {rows} rows: rows bitwise equal {eq}; kernels "
              f"{kernels(lambda: padded(x, w, rows))}; a verify round {t_v:.4f} ms "
              f"(+{t_v - t_plain_v:.4f}), a decode step {t_d:.4f} ms (+{t_d - t_plain_d:.4f})",
              flush=True)
        out[f"b{rows}"] = {"equal": eq, "round_ms": t_v - t_plain_v,
                           "step_ms": t_d - t_plain_d}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("verify_rows: no CUDA device visible to torch")
    g = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16
    out = {}
    for model, shapes in (("olmo-1b", OLMO), ("minicpm3-4b", MINICPM)):
        print(f"{model}: products at a verify round of {S} slots x {T} tokens against "
              f"the decode step's {S} rows", flush=True)
        for label, (k, n) in shapes.items():
            w = (torch.randn((k, n), generator=g, device="cuda") * k ** -0.5).to(bf)
            if "tied" in label:
                w = w.T.contiguous().T          # [K, N] view of an [N, K] embedding
            x = torch.randn((S * T, k), generator=g, device="cuda").to(bf)
            rows_t = [x[t::T].contiguous() for t in range(T)]      # the decode steps' rows
            out[model, label] = compare(label, lambda x=x, w=w: x @ w,
                                        lambda t, r=rows_t, w=w: r[t] @ w)
            if not out[model, label]:
                repairs(label, x, w)
    # minicpm3-4b's absorbed einsums: W_uk into the query, W_uv out of the latent
    h, dn, r, dv = 40, 64, 256, 64
    wuk = (torch.randn((r, h, dn), generator=g, device="cuda") * r ** -0.5).to(bf)
    wuv = (torch.randn((r, h, dv), generator=g, device="cuda") * r ** -0.5).to(bf)
    qn = torch.randn((S, T, h, dn), generator=g, device="cuda").to(bf)
    ol = torch.randn((S, T, h, r), generator=g, device="cuda").to(bf)
    for label, fn in (("absorb W_uk (bqhd,rhd->bqhr)",
                       lambda q: torch.einsum("bqhd,rhd->bqhr", q, wuk)),
                      ("W_uv out (bqhr,rhd->bqhd)",
                       lambda o: torch.einsum("bqhr,rhd->bqhd", o, wuv))):
        src = qn if "W_uk" in label else ol
        rows_t = [src[:, t:t + 1] for t in range(T)]
        out["minicpm3-4b", label] = compare(
            label, lambda fn=fn, src=src: fn(src).reshape(S * T, -1),
            lambda t, fn=fn, r=rows_t: fn(r[t]).reshape(S, -1))
    from repro_torch.models.layers import Ctx, norm_apply
    from repro_torch.models.model import STEP_MIN_ROWS

    print(f"norms, unpadded and padded to {STEP_MIN_ROWS} rows (Model.step_ctx)", flush=True)
    for model, kind, d in (("olmo-1b", "layernorm_np", 2048), ("minicpm3-4b", "rmsnorm", 2560),
                           ("minicpm3-4b", "rmsnorm", 768), ("minicpm3-4b", "rmsnorm", 256)):
        p = {} if kind == "layernorm_np" else {"scale": torch.ones(d, device="cuda")}
        x = torch.randn((S * T, d), generator=g, device="cuda").to(bf)
        rows_t = [x[t::T].contiguous() for t in range(T)]
        for rows in (0, STEP_MIN_ROWS):
            ctx = Ctx(dtype=bf, step_min_rows=rows)
            label = f"{kind} d {d}" + (f", padded to {rows}" if rows else "")
            out[model, label] = compare(
                label, lambda x=x, ctx=ctx, p=p, kind=kind: norm_apply(p, x, kind, ctx),
                lambda t, r=rows_t, ctx=ctx, p=p, kind=kind: norm_apply(p, r[t], kind, ctx))
    differ = [f"{m} {k}" for (m, k), eq in out.items() if not eq]
    print(f"products whose verify rows differ from the decode step's: {differ or 'none'}",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
