"""Where two serves of one trace part on one GPU: what sets the floor of
``chip_smoke.py`` phase 13's step-aligned logit comparison (a chunked,
preempting serve against the plain serve of the same trace).

    python3 probes/serve_rows.py

1. The plain serve of phase 13's trace (olmo-1b at full width, bf16, K2)
   twice: are its logits bitwise equal run to run?
2. A decode step's products at the serve's shapes (8 slots, d_model 2048):
   does a row's result depend on its slot (rows permuted) or on how many
   rows share the product (one row alone)?
3. The same for a whole decode step of the model: 8 prompts prefilled into
   a contiguous cache, one step, then the same step with the slots
   permuted, and with one slot alone.

Prints one line each, then the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.softmax_variants import SoftmaxSpec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402


def rows_differing(a, b):
    d = (a.float() - b.float()).abs()
    return int((d.reshape(d.shape[0], -1) > 0).any(-1).sum()), float(d.max())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serve_rows: no CUDA device visible to torch")
    cfg = get_config("olmo-1b", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))

    # 1. the plain serve twice
    reqs = chip_smoke.phase13_trace()
    opts = chip_smoke.phase13_options(reqs, chunked=False)
    rec = chip_smoke._LogitRecorder()
    eng = Engine(model, params, max_new=64, sampler=rec)
    runs = [chip_smoke.counted_serve(eng, reqs, opts, rec) for _ in range(2)]
    (a, _, rows_a, _), (b, _, rows_b, _) = runs
    same = sum(torch.equal(torch.stack(rows_a[r.seed]), torch.stack(rows_b[r.seed]))
               for r in reqs)
    al = chip_smoke.aligned_logits("plain serve, run 1 vs run 2", reqs, a.results, b.results,
                                   rows_a, rows_b)
    print(f"plain serve twice: {same} of {len(reqs)} requests' logits bitwise equal; "
          f"step-aligned max {al['max']:.4g}, RMS {al['rms']:.4g}", flush=True)

    # 2. one product at the decode step's shapes
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((8, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    for name, w in (("wq", params["stack"]["layers"]["attn"]["wq"]["w"][0]),
                    ("up", params["stack"]["layers"]["ffn"]["up"]["w"][0])):
        y = x @ w
        perm = torch.randperm(8, generator=g, device="cuda")
        n_perm, d_perm = rows_differing((x[perm] @ w), y[perm])
        n_one, d_one = rows_differing(x[:1] @ w, y[:1])
        print(f"decode product {name} [8, {w.shape[0]}] x {list(w.shape)}: rows permuted "
              f"{n_perm} of 8 rows differ (max {d_perm:.4g}); one row alone {n_one} of 1 "
              f"differs (max {d_one:.4g})", flush=True)

    # 3. a whole decode step, contiguous cache, K1 on the decode rows
    prompts = torch.randint(0, cfg.vocab, (8, 400), generator=g, device="cuda")
    _, cache = model.prefill(params, {"tokens": prompts}, cache_len=448)
    tok = torch.randint(0, cfg.vocab, (8, 1), generator=g, device="cuda")

    def step(idx):
        c = {k: v[:, idx].clone() for k, v in cache.items()}
        logits, _ = model.decode_step(params, c, {"token": tok[idx]}, 400)
        return logits[:, -1]

    full = step(torch.arange(8, device="cuda"))
    perm = torch.randperm(8, generator=g, device="cuda")
    n_perm, d_perm = rows_differing(step(perm), full[perm])
    n_one, d_one = rows_differing(step(torch.arange(1, device="cuda")), full[:1])
    print(f"decode step (8 slots, 400 positions): slots permuted {n_perm} of 8 rows' logits "
          f"differ (max {d_perm:.4g}); one slot alone {n_one} of 1 differs (max {d_one:.4g})",
          flush=True)
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
