"""Which op of a whisper-base decode step gives a slot of the serve's
4-slot step other bits than the same request's batch-1 eager step? What
sets ``chip_smoke.py`` phase 18's serve == eager on the card.

    python3 probes/encdec_rows.py

Full-width whisper-base (seeded bf16 weights, softmax ``int_pallas``) with
4 requests of 1500 encoder frames and 16-token prompts, each prefilled at
batch 1 and put in its slot of a 4-slot cache (as ``Engine.serve`` admits
them). One ``Model.decode_step`` over the 4 slots, then for each slot the
same step at batch 1 from a copy of its stripe (as the eager generate
steps it). Every norm, dense product, attention (``attention.attend``:
scores, Alg. 1, PV) and the read-out is recorded in call order; the line
of a run gives, for each op name, how many of its calls give every slot's
row bitwise equal to the batch-1 steps' and the first call that does not.
Runs: the model's step padding (``Model.step_ctx``), every dense product
of the step padded to ``STEP_MIN_ROWS`` rows as well, and that with each
attention computed slot by slot (one batch-1 call a slot).

One step's rows can agree by chance where two kernels sum in different
orders (a bf16 result flips only near a rounding boundary), so each
product of the step is then drawn ``DRAWS`` times on its own: 4 random
rows at once against each row alone, unpadded and padded to
``STEP_MIN_ROWS`` rows, and the attention's two einsums (scores and PV,
over the 1500 frames and over a 96-key self cache) at batch 4 against
batch 1; each line counts the differing elements. Then the card's name
and power limit.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

SLOTS, ENC, P, CACHE = 4, 1500, 16, 64
DRAWS = 64
# the step's products (K, N) at whisper-base's widths; the tied head
# multiplies by the embedding's transpose
PRODUCTS = {"q / k / v / o (self, cross)": (512, 512), "gate / up": (512, 2048),
            "down": (2048, 512), "head (tied)": (512, 51865)}


class Recorder:
    """Wraps the model's ops where the model looks them up, recording each
    call's output under the op's name."""

    def __init__(self):
        from repro_torch.models import attention, layers, model, transformer

        self.calls, self.patches, self.on = [], [], False
        # what each recorded call runs (a run may swap ``inner["attend"]``)
        self.inner = {}
        for mod, names in ((attention, ("dense_apply", "attend")),
                           (layers, ("dense_apply",)),
                           (transformer, ("norm_apply",)),
                           (model, ("norm_apply", "embed_logits"))):
            for name in names:
                self._wrap(mod, name)

    def _wrap(self, owner, attr):
        orig = getattr(owner, attr)
        key = f"{owner.__name__}.{attr}"
        self.inner[key] = orig

        def recorded(*args, **kw):
            out = self.inner[key](*args, **kw)
            if self.on:
                self.calls.append((attr, out.clone()))
            return out

        setattr(owner, attr, recorded)
        self.patches.append((owner, attr, orig))

    def run(self, fn):
        self.calls, self.on = [], True
        try:
            fn()
        finally:
            self.on = False
        return self.calls

    def restore(self):
        for owner, attr, orig in reversed(self.patches):
            setattr(owner, attr, orig)


def slot_by_slot(attend):
    """``attend`` one batch row at a time (each a batch-1 call)."""
    def per_slot(q, k, v, mask, cfg, ctx, scale=None, smx=None):
        return torch.cat([attend(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                 None if mask is None else mask[i:i + 1] if mask.shape[0] > 1
                                 else mask, cfg, ctx, scale, smx)
                          for i in range(q.shape[0])])
    return per_slot


def compare(label, model, params, cache, token, pos, rec):
    from repro_torch.models.kv_cache import tree_map

    batch = tree_map(lambda v: v.clone(), cache)
    full = rec.run(lambda: model.decode_step(params, batch, {"token": token}, pos))
    singles = []
    for s in range(SLOTS):
        one = tree_map(lambda v: v[:, s:s + 1].clone(), cache)
        singles.append(rec.run(lambda s=s, one=one: model.decode_step(
            params, one, {"token": token[s:s + 1]}, pos[s:s + 1])))
    assert all(len(c) == len(full) for c in singles), "the runs made different calls"
    by_op = {}
    for i, (name, out) in enumerate(full):
        ok = all(torch.equal(out[s:s + 1], singles[s][i][1]) for s in range(SLOTS))
        seen = by_op.setdefault(name, {"calls": 0, "equal": 0, "first_differing_call": None})
        seen["calls"] += 1
        seen["equal"] += ok
        if not ok and seen["first_differing_call"] is None:
            seen["first_differing_call"] = i
    first = min((v["first_differing_call"] for v in by_op.values()
                 if v["first_differing_call"] is not None), default=None)
    print(f"{label}: {len(full)} recorded calls; by op {by_op}; first differing call {first}"
          f"{'' if first is None else ' (' + full[first][0] + ')'}", flush=True)


def drawn_products(rows):
    """Differing elements of each step product: ``DRAWS`` draws of 4 rows,
    the 4-row product against each row alone, both padded to ``rows``
    rows (0: unpadded)."""
    from repro_torch.models.layers import _rows_matmul

    g = torch.Generator("cuda").manual_seed(0)
    out = {}
    for name, (k, n) in PRODUCTS.items():
        w = (torch.randn((k, n), generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
        diff = 0
        for _ in range(DRAWS):
            x = torch.randn((SLOTS, k), generator=g, device="cuda").to(torch.bfloat16)
            full = _rows_matmul(x, w, rows)
            diff += sum(int((full[i:i + 1] != _rows_matmul(x[i:i + 1], w, rows)).sum())
                        for i in range(SLOTS))
        out[name] = diff
    return out


def drawn_einsums():
    """Differing elements of the attention's einsums at batch 4 against
    batch 1 (``DRAWS`` draws), as ``attention.attend`` forms them for a
    decode step (8 heads of 64, group 1)."""
    g = torch.Generator("cuda").manual_seed(1)
    bf = torch.bfloat16
    out = {}
    for keys in (ENC, 96):
        sc = pv = 0
        for _ in range(DRAWS):
            q = torch.randn((SLOTS, 1, 8, 1, 64), generator=g, device="cuda").to(bf)
            k = torch.randn((SLOTS, keys, 8, 64), generator=g, device="cuda").to(bf)
            w = torch.rand((SLOTS, 8, 1, 1, keys), generator=g, device="cuda").to(bf)
            s4 = torch.einsum("bqkgd,bskd->bkgqs", q, k)
            o4 = torch.einsum("bkgqs,bskd->bqkgd", w, k)
            for i in range(SLOTS):
                sl = slice(i, i + 1)
                sc += int((s4[sl] != torch.einsum("bqkgd,bskd->bkgqs", q[sl], k[sl])).sum())
                pv += int((o4[sl] != torch.einsum("bkgqs,bskd->bqkgd", w[sl], k[sl])).sum())
        out[f"{keys} keys"] = {"scores": sc, "pv": pv}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("encdec_rows: no CUDA device visible to torch")
    from repro_torch.configs.registry import get_config
    from repro_torch.core.softmax_variants import SoftmaxSpec
    from repro_torch.models import attention, kv_cache
    from repro_torch.models.model import STEP_MIN_ROWS, Model

    cfg = get_config("whisper-base", softmax=SoftmaxSpec("int_pallas"))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    cache = kv_cache.cache_zeros(cfg, SLOTS, CACHE, device="cuda", enc_len=ENC)
    with torch.no_grad():
        for s in range(SLOTS):
            batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, P)), device="cuda"),
                     "frames": torch.as_tensor(rng.standard_normal((1, ENC, cfg.d_model)),
                                               dtype=torch.float32, device="cuda")}
            _, c = model.prefill(params, batch, cache_len=CACHE)
            kv_cache.insert_slot(cache, c, s)
    token = torch.as_tensor(rng.integers(0, cfg.vocab, (SLOTS, 1)), device="cuda")
    pos = torch.full((SLOTS,), P, dtype=torch.int32, device="cuda")
    rec = Recorder()
    step_ctx = model.step_ctx
    try:
        with torch.no_grad():
            compare(f"{cfg.name}, {SLOTS} slots against batch 1, the model's step padding",
                    model, params, cache, token, pos, rec)
            model.step_ctx = dataclasses.replace(step_ctx, min_rows=STEP_MIN_ROWS)
            compare(f"{cfg.name}, every dense product at {STEP_MIN_ROWS} rows too", model,
                    params, cache, token, pos, rec)
            key = f"{attention.__name__}.attend"
            attend = rec.inner[key]
            rec.inner[key] = slot_by_slot(attend)
            try:
                compare(f"{cfg.name}, every dense product at {STEP_MIN_ROWS} rows, attention "
                        "slot by slot", model, params, cache, token, pos, rec)
            finally:
                rec.inner[key] = attend
    finally:
        model.step_ctx = step_ctx
        rec.restore()
    with torch.no_grad():
        for rows in (0, STEP_MIN_ROWS):
            print(f"products, {SLOTS} rows against 1, {DRAWS} draws, "
                  f"{'unpadded' if not rows else f'padded to {rows} rows'}: differing elements "
                  f"{drawn_products(rows)}", flush=True)
        print(f"attention einsums, batch {SLOTS} against 1, {DRAWS} draws: differing elements "
              f"{drawn_einsums()}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
