"""The H100's roofline (port of ``src/repro/launch/roofline.py``): the card's
data-sheet rates, the reference's roofline functions with those rates as
their defaults, the kernels' and the model paths' least-time bounds that
``chip_smoke.py`` prints, and an analytic work count of a model cell.

Three terms a step, in seconds:

  compute    = FLOPs / peak rate of their type
  memory     = bytes / HBM rate
  collective = collective operand bytes / link rate

The reference reads its FLOPs and bytes from XLA's cost analysis and its
collective bytes from the optimized HLO (``collective_bytes``). The port's
collectives are explicit calls (``distributed/collectives.py``), so the dry
run counts them there (``collectives.count_collectives``) and has no HLO
to parse. Every function that takes rates takes them as keyword arguments
defaulting to the card's, so the reference's v5e rates give the
reference's numbers.

The card: an H100 SXM at 700 W (NVIDIA's data sheet, dense rates without
sparsity): 989 TFLOP/s of bf16 on the tensor cores, 67 TFLOP/s of f32
outside them, 3.35 TB/s of HBM3 (other parts by name: ``hbm_rate``),
NVLink 450 GB/s each way, 132 SMs with 232,448 B of shared memory a
block.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# ----------------------------------------------------------- the card's rates

PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, FLOP/s
ALU_FLOPS = 67e12            # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, B/s
LINK_BW = 450e9              # NVLink, each way, B/s
SMEM_PER_BLOCK = 232_448     # opt-in shared memory a block, B
SMS = 132

# Data-sheet HBM rates (B/s) by card name, most specific first.
HBM_RATES = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12)]
# K1's int32 work is counted at the f32 rate outside the tensor cores: the
# int32 rate is no higher, so this under-states the operation bound, which
# stays far below the memory bound.
K1_OPS_PER_ELEMENT = 40      # quantize ~6, exp ~16, sum 1, divide + dequant ~17
# The dots and the PV of K2-K4 multiply compute-dtype operands and
# accumulate in f32: tensor-core work for bf16, counted at the bf16 peak;
# f32 operands outside the tensor cores (no TF32).
MMA_RATE = {torch.bfloat16: PEAK_FLOPS, torch.float32: ALU_FLOPS}


def hbm_rate(name: str) -> float:
    """The data-sheet HBM rate of the card named ``name``
    (``torch.cuda.get_device_name``)."""
    for key, rate in HBM_RATES:
        if key in name:
            return rate
    raise ValueError(f"no data-sheet memory rate for card {name!r}")


# ------------------------------------------------- the reference's functions

def roofline_terms(flops_pd: float, bytes_pd: float, coll_bytes_pd: float, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    compute = flops_pd / peak_flops
    memory = bytes_pd / hbm_bw
    collective = coll_bytes_pd / link_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dominant, "bound_s": max(compute, memory, collective)}


def model_flops_train(active_params: float, tokens: float, attn_flops: float = 0.0) -> float:
    """6 * N_active * D (+ the attention quadratic term), global."""
    return 6.0 * active_params * tokens + attn_flops


def mfu_like(model_flops_global: float, flops_pd: float, n_chips: int) -> float:
    """MODEL_FLOPS / counted FLOPs: how much of the counted compute is useful."""
    total = flops_pd * n_chips
    return model_flops_global / total if total else float("nan")


def paged_tile_smem_bytes(rows: int, chunk_pages: int, block_size: int) -> int:
    """Shared memory of K2's f32 score tile for one CTA: the rows it takes
    (``k2_row_group``) times its chunk's keys, at most ``K2_TILE_BYTES``
    (the plan of ``kernels/paged_attention/ref.py``)."""
    from repro_torch.kernels.paged_attention.ref import k2_row_group

    return 4 * k2_row_group(rows, chunk_pages, block_size) * chunk_pages * block_size


def paged_decode_operator(slots: int, kv_heads: int, rows: int, d_head: int,
                          dv_head: int, pages_touched: int, block_size: int,
                          n_logical: int, compute_bytes: int = 2,
                          quant: bool = False, *, peak_flops: float = PEAK_FLOPS,
                          hbm_bw: float = HBM_BW, link_bw: float = LINK_BW,
                          sms: int = SMS) -> Dict[str, float]:
    """Roofline terms of one fused paged-decode step (K2), beside the
    gather-then-attend bytes it replaces. The fused kernel streams only the
    pages touched, ``pages_touched * block_size`` K and V rows a (slot,
    kv-head), once; the gather path writes and reads back the whole
    ``n_logical * block_size`` logical cache. Also K2's plan at this shape
    (``k2_split_plan`` on ``sms`` SMs) and its score tile's shared memory."""
    from repro_torch.kernels.paged_attention.ref import K2_TILE_BYTES, k2_split_plan

    elt = 1 if quant else compute_bytes
    l_live = pages_touched * block_size
    l_full = n_logical * block_size
    kv_bytes = slots * kv_heads * l_live * (d_head + dv_head) * elt
    if quant:
        kv_bytes += 2 * slots * kv_heads * l_live * 4
    q_o_bytes = slots * kv_heads * rows * (d_head + dv_head) * compute_bytes
    flops = 2.0 * slots * kv_heads * rows * l_live * (d_head + dv_head)
    terms = roofline_terms(flops, kv_bytes + q_o_bytes, 0.0, peak_flops=peak_flops,
                           hbm_bw=hbm_bw, link_bw=link_bw)
    gather = slots * kv_heads * l_full * (d_head + dv_head) * elt * 3
    terms["fused_bytes"] = kv_bytes + q_o_bytes
    terms["gather_bytes"] = float(gather)
    terms["bytes_ratio"] = gather / max(kv_bytes + q_o_bytes, 1.0)
    cp = k2_split_plan(slots, kv_heads, rows, n_logical, block_size, sms)
    terms["chunk_pages"] = cp
    terms["tile_smem_bytes"] = paged_tile_smem_bytes(rows, cp, block_size)
    terms["tile_smem_limit"] = K2_TILE_BYTES
    return terms


# ------------------------------------------------------- the kernels' bounds

def operations_ms(mma_flops: float, dtype, alu_ops: float) -> float:
    """Least time of the operations: the products at their operand type's
    peak and Alg. 1 at ``ALU_FLOPS``, on separate units, so the larger."""
    return max(mma_flops / MMA_RATE[dtype], alu_ops / ALU_FLOPS) * 1e3


def _bound(nbytes: float, op_ms: float, rate: float, **extra) -> dict:
    bytes_ms = nbytes / rate * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "op_ms": op_ms,
            "bound_ms": max(bytes_ms, op_ms),
            "bound_by": "bytes" if bytes_ms >= op_ms else "operations", **extra}


def k1_bound(rows: int, cols: int, masked: bool, rate: float = HBM_BW) -> dict:
    """K1 on f32 scores [rows, cols] (and a uint8 mask): the scores read and
    the probabilities written once; Alg. 1 per element."""
    nbytes = rows * cols * (4 + 4 + (1 if masked else 0))
    return _bound(nbytes, operations_ms(0, torch.float32, rows * cols * K1_OPS_PER_ELEMENT),
                  rate)


def _esz(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def k2_bound(q, k, v, table, pos, *, group: int, window: int = 0, quant: bool = False,
             dtype=torch.bfloat16, rate: float = HBM_BW) -> dict:
    """K2 on queries q [S, KV, rows, D] over pools k / v [NB, BS, KV, D]
    through ``table`` [S, NLOG] at positions ``pos`` [S, T]: the K and V
    rows the function needs (keys at or below some row's position, inside
    its window, on a live page; int8 pools: a byte a value and the two f32
    scales), q, the output, table and positions, each once; operations: the
    dot and the PV per needed key and row (at the operand type's rate) and
    Alg. 1 per score."""
    nb, bs, kvh, d = k.shape
    dv = v.shape[-1]
    esz = _esz(dtype)
    tab, ps = np.asarray(torch.as_tensor(table).cpu()), np.asarray(torch.as_tensor(pos).cpu())
    l_full = tab.shape[1] * bs
    kp = np.arange(l_full)
    need = kp <= ps[:, :, None]                                    # [S, T, L]
    if window:
        need &= kp > ps[:, :, None] - window
    need &= ((tab >= 0) & (tab < nb))[:, kp // bs][:, None, :]
    keys_read = int(need.any(axis=1).sum())           # a slot's rows share their keys
    row_keys = int(need.sum()) * group
    kv_bytes = (d + dv + 8) if quant else (d + dv) * esz
    out_elems = q.shape[0] * q.shape[1] * q.shape[2] * dv
    nbytes = (keys_read * kvh * kv_bytes + (q.numel() + out_elems) * esz
              + tab.size * 4 + ps.size * 4)
    op_ms = operations_ms(row_keys * kvh * (2 * d + 2 * dv), dtype,
                          row_keys * kvh * K1_OPS_PER_ELEMENT)
    return _bound(nbytes, op_ms, rate, keys_read=keys_read)


def k3_bound(q, k, v, *, causal: bool, window: int = 0, dtype=torch.bfloat16,
             rate: float = HBM_BW) -> dict:
    """K3 on q [BH, Sq, D], k / v [BKV, Skv, D]: q, k, v read once and the
    f32 output written once; operations: the dot and the PV per valid (row,
    key) at the operand type's rate, Alg. 1 per valid score."""
    from repro_torch.kernels.int_attention.ref import attention_mask

    bh, sq, d = q.shape
    skv = k.shape[1]
    mask = attention_mask(sq, skv, causal, window)
    pairs = (sq * skv if mask is None else int(mask.sum())) * bh
    nbytes = (q.numel() + k.numel() + v.numel()) * _esz(dtype) + bh * sq * v.shape[-1] * 4
    return _bound(nbytes, operations_ms(pairs * 4 * d, dtype, pairs * K1_OPS_PER_ELEMENT),
                  rate)


def k4_bound(q_lat, q_rope, c, kr, table, pos, *, heads: int, dtype=torch.bfloat16,
             rate: float = HBM_BW) -> dict:
    """K4 on latent queries q_lat [S, rows, R] / q_rope [S, rows, DR] over the
    latent pools c [NB, BS, R] / kr [NB, BS, DR]: the latent and rope rows
    the function needs (keys at or below some row's position, on a live
    page), the queries, the output, table and positions, each once;
    operations: both dots and the PV per needed (row, key) at the operand
    type's rate, and Alg. 1."""
    nb, bs, r = c.shape
    dr = kr.shape[-1]
    tab, ps = np.asarray(torch.as_tensor(table).cpu()), np.asarray(torch.as_tensor(pos).cpu())
    kpos = np.arange(tab.shape[1] * bs)
    live = ((kpos <= np.repeat(ps, heads, axis=1)[:, :, None])
            & ((tab >= 0) & (tab < nb))[:, kpos // bs][:, None, :])
    keys_read = int(live.any(axis=1).sum())                    # a slot's rows share keys
    row_keys = int(live.sum())
    esz = _esz(dtype)
    nbytes = (keys_read * (r + dr) * esz + (2 * q_lat.numel() + q_rope.numel()) * esz
              + tab.size * 4 + ps.size * 4)
    op_ms = operations_ms(row_keys * (2 * (r + dr) + 2 * r), dtype,
                          row_keys * K1_OPS_PER_ELEMENT)
    return _bound(nbytes, op_ms, rate, keys_read=keys_read)


# --------------------------------------------------- the model paths' bounds

def named_leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict / list / tuple tree
    (a ``TrainState`` among them; None leaves left out)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [nl for k, v in tree.items() for nl in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [nl for i, v in enumerate(tree) for nl in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for _, v in named_leaves(tree))


def weight_read_bound_ms(params, rate: float = HBM_BW) -> float:
    """A decode step reads every weight once but the embedding table (it
    reads B rows of it): those bytes at ``rate``."""
    return tree_bytes({k: v for k, v in params.items() if k != "embed"}) / rate * 1e3


def decode_bound_ms(params, cache, rate: float = HBM_BW) -> float:
    """A decode step's bytes bound: every weight but the embedding read once,
    and the decode state (SSM state and conv tail, window rings, the
    prefix's K/V) read once and its SSM state written once, at ``rate``."""
    state = sum(v.numel() * v.element_size() for k, v in named_leaves(cache)
                if k.endswith("state"))
    rest = tree_bytes({k: v for k, v in params.items() if k != "embed"})
    return (rest + tree_bytes(cache) + state) / rate * 1e3


def train_6nt(params, tokens: int, peak: float = PEAK_FLOPS):
    """6 N T: the forward and backward products of the N weights a token
    meets (every ``.../w`` leaf, the tied embedding's read-out included),
    and their time at ``peak``. Returns (FLOPs, ms)."""
    n_mm = sum(v.numel() for k, v in named_leaves(params) if k.endswith("/w"))
    flops = 6 * n_mm * tokens
    return flops, flops / peak * 1e3


# ------------------------------------------------- a model cell's least work

def live_keys(cache, pos) -> list:
    """Per row of a paged decode step over ``cache`` at positions ``pos``
    [rows], the keys its query needs: positions at or below the row's on a
    live page of its block table (the first paged node's first layer; an
    entry outside ``[0, num_blocks)`` is a sentinel)."""
    from repro_torch.models import kv_cache

    node = kv_cache._paged_nodes(cache)[0]
    pool = node[kv_cache._pools(node)[0]]                # [L, NB, BS, ...]
    nb, bs = pool.shape[1], pool.shape[2]
    tab = np.asarray(node["table"][0].cpu())
    ps = np.asarray(torch.as_tensor(pos).cpu()).reshape(-1)
    kp = np.arange(tab.shape[1] * bs)
    live = ((tab >= 0) & (tab < nb))[:, kp // bs]
    return [int(n) for n in (live & (kp <= ps[:, None])).sum(axis=1)]


class _Products:
    """Product FLOPs of a step, each with the operands a backward pass
    takes gradients of and whether its layer is rematerialised."""

    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0
        self.remat = {"mm": 0.0, "bmm": 0.0}

    def add(self, flops: float, grads: int = 2, batched: bool = False, block: bool = True,
            tail: bool = False):
        """``tail``: the block's last product, whose output the backward
        does not keep, so a rematerialised block stops before it."""
        self.fwd += flops
        self.bwd += flops * grads
        if block and not tail:
            self.remat["bmm" if batched else "mm"] += flops


def _score_grad(cfg) -> bool:
    """Whether the softmax backend's output carries a gradient back to the
    scores; where it does not, the query and key paths get no backward."""
    from repro_torch.core.softmax_variants import spec_backend

    backend = spec_backend(cfg.softmax)
    if not backend.differentiable:
        return False
    x = torch.zeros((1, 2), requires_grad=True)
    with torch.enable_grad():
        return bool(backend.apply(x).requires_grad)


def _attention(pr: _Products, cfg, rows: int, pairs: float, sg: bool,
               kv_rows: Optional[int] = None):
    """GQA attention of ``rows`` query rows over ``pairs`` (query row, key)
    pairs a head: the projections, QK^T, PV, wo. ``kv_rows``: the rows the
    K / V projections run over (cross-attention; 0 when they are cached)."""
    h, kv, d, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.d_head
    kv_rows = rows if kv_rows is None else kv_rows
    qk = 2 if sg else 0                        # the query / key path's backward
    pr.add(2 * rows * d * h * dh, qk)                                 # wq
    pr.add(2 * kv_rows * d * kv * dh, qk)                             # wk
    pr.add(2 * kv_rows * d * kv * dh, 2)                              # wv
    pr.add(2 * h * pairs * dh, qk, batched=True)                      # QK^T
    pr.add(2 * h * pairs * dh, 2 if sg else 1, batched=True)          # PV
    pr.add(2 * rows * h * dh * d, 2)                                  # wo


def _mla(pr: _Products, cfg, rows: int, pairs: float, sg: bool, absorbed: bool):
    """MLA of ``rows`` query rows over ``pairs`` pairs a head: absorbed
    (a decode step, over the latent cache) or with every key's K / V
    expanded from its latent (prefill and training, a key a query row)."""
    h, d = cfg.n_heads, cfg.d_model
    r_, dr, dn, dv, ql = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                          cfg.v_head_dim, cfg.q_lora_rank)
    qk = 2 if sg else 0
    if ql:
        pr.add(2 * rows * d * ql, qk)
        pr.add(2 * rows * ql * h * (dn + dr), qk)
    else:
        pr.add(2 * rows * d * h * (dn + dr), qk)
    pr.add(2 * rows * d * r_, 2)                                      # wdkv
    pr.add(2 * rows * d * dr, qk)                                     # wkr
    if absorbed:
        pr.add(2 * rows * h * dn * r_, qk, batched=True)               # q_lat
        pr.add(2 * h * pairs * (r_ + dr), qk, batched=True)            # scores
        pr.add(2 * h * pairs * r_, 2 if sg else 1, batched=True)       # PV on c
        pr.add(2 * rows * h * r_ * dv, 2, batched=True)                # W_uv
    else:
        pr.add(2 * rows * r_ * h * dn, qk)                             # wuk
        pr.add(2 * rows * r_ * h * dv, 2)                              # wuv
        pr.add(2 * h * pairs * (dn + dr), qk, batched=True)
        pr.add(2 * h * pairs * dv, 2 if sg else 1, batched=True)
    pr.add(2 * rows * h * dv * d, 2)                                  # wo


def _glu(pr: _Products, rows: int, d: int, f: int, tail: bool = True):
    pr.add(2 * rows * d * f, 2)
    pr.add(2 * rows * d * f, 2)
    pr.add(2 * rows * f * d, 2, tail=tail)


def _moe(pr: _Products, cfg, b: int, t: int, least: bool):
    """The router, the experts (least: each row through its top-k experts;
    the port: every expert over its slots, G x C a sequence, ``moe.groups``:
    C, or under ``"a2a"`` C_seg in each of its segments) and the shared
    experts."""
    from repro_torch.models.moe import groups

    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    rows = b * t
    pr.add(2 * rows * d * e, 2)                                       # router
    g, c = groups(cfg, t)
    expert_rows = rows * cfg.moe_top_k if least else e * b * g * c
    for _ in range(3):
        pr.add(2 * expert_rows * d * f, 2, batched=True)              # the experts
    if cfg.n_shared_experts:
        _glu(pr, rows, d, cfg.n_shared_experts * f)


def _ssm(pr: _Products, cfg, b: int, t: int, step: bool, least: bool, tail: bool = True):
    """An SSD block: in_proj, the scan's products, out_proj. The scan's
    least products are the recurrent form's read-out C . state a token
    (its state update is elementwise); the port's prefill and training run
    the chunked form's four products instead."""
    d, di, n, g, h, p = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                         cfg.ssm_nheads, cfg.ssm_head_dim)
    rows = b * t
    pr.add(2 * rows * d * (2 * di + 2 * g * n + h), 2)                 # in_proj
    if step or least:
        pr.add(2 * rows * h * p * n, 2, batched=True)                  # C . state
    else:
        q = min(cfg.ssm_chunk, t)
        nc = t // q
        pr.add(2 * b * nc * h * q * q * n, 2, batched=True)            # C B^T
        pr.add(2 * b * nc * h * q * q * p, 2, batched=True)            # y_diag
        pr.add(2 * b * nc * h * q * p * n, 2, batched=True)            # chunk states
        pr.add(2 * b * nc * h * q * n * p, 2, batched=True)            # y_off
    pr.add(2 * rows * di * d, 2, tail=tail)                           # out_proj


def _layers(pr: _Products, cfg, b: int, t: int, pairs: dict, step: bool, sg: bool,
            least: bool):
    """Every layer of the decoder stack of b x t tokens; ``pairs``: the
    (query row, key) pairs a head of a global ("full") and a window layer."""
    d, f = cfg.d_model, cfg.d_ff
    rows = b * t
    if cfg.family == "ssm":
        for _ in range(cfg.n_layers):
            _ssm(pr, cfg, b, t, step, least)
        return
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import full_attn_layer_ids

        for i in range(cfg.n_layers):
            full = i in full_attn_layer_ids(cfg)
            _attention(pr, cfg, rows, pairs["full" if full else "window"], sg)
            _ssm(pr, cfg, b, t, step, least, tail=False)
            _glu(pr, rows, d, f)
        return
    n_moe = cfg.n_layers - cfg.n_dense_prefix if cfg.family == "moe" else 0
    for i in range(cfg.n_layers):
        if cfg.attention == "mla":
            _mla(pr, cfg, rows, pairs["full"], sg, absorbed=step)
        else:
            _attention(pr, cfg, rows, pairs["full"], sg)
        if i >= cfg.n_layers - n_moe:
            _moe(pr, cfg, b, t, least)
        else:
            _glu(pr, rows, d, f)


def _head(pr: _Products, cfg, rows: int):
    pr.add(2 * rows * cfg.d_model * cfg.vocab, 2, block=False)


def _encdec(pr: _Products, cfg, b: int, t: int, self_pairs: float, enc: int, step: bool,
            sg: bool):
    """whisper-base: the encoder over ``enc`` frames (prefill and train) and
    the decoder's b x t tokens over ``self_pairs`` self pairs a head and
    ``enc`` cross keys (whose K / V a decode step reads from its cache)."""
    d, f = cfg.d_model, cfg.d_ff
    if not step:
        for _ in range(cfg.n_layers):
            _attention(pr, cfg, b * enc, b * enc * enc, sg)
            _glu(pr, b * enc, d, f)
    for _ in range(cfg.n_layers):
        _attention(pr, cfg, b * t, self_pairs, sg)
        _attention(pr, cfg, b * t, b * t * enc, sg, kv_rows=0 if step else b * enc)
        _glu(pr, b * t, d, f)


def _causal_pairs(b: int, t: int, window: Optional[int]) -> float:
    """(query, key) pairs of b causal sequences of t tokens, each query
    over at most ``window`` keys."""
    i = np.arange(1, t + 1)
    return float(b * (np.minimum(i, window) if window else i).sum())


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def model_work(cfg, kind: str, batch: int, seq: int, *, max_new: int = 0,
               cache_len: Optional[int] = None, keys=None, enc_len: int = 0,
               dec_prompt: int = 64, params_dtype=None, rate: float = HBM_BW,
               peak: float = PEAK_FLOPS) -> dict:
    """The least work of one cell of ``cfg``, whatever implements it, beside
    the products the port's own (plain, contiguous-cache) code computes.

    ``kind``: "prefill" (``batch`` x ``seq`` prompt tokens; the encoder-
    decoder: ``seq`` frames and ``dec_prompt`` decoder tokens), "decode"
    (one token a row) or "generate" (``max_new`` decode steps) over a
    cache of ``cache_len`` positions (default ``seq``), or "train" (a
    forward and backward pass over ``batch`` x ``seq`` tokens, then AdamW).
    ``keys``: the live keys of each row's query at the (first) decode
    step, an int or one a row (a paged step: ``live_keys``); default a
    full cache for "decode" and, for "generate", the ``cache_len -
    max_new`` prompt positions and the new one; each later step one more.

    ``flops``, the least products (2 x the multiply-adds): the projections,
    the attention scores and PV over the (query, key) pairs the function
    needs (a causal query's earlier keys, a window layer's last
    ``window``, a decode row's live keys), each row through its top-k
    experts, an SSD block's read-out C . state a token, the LM head over
    the tokens whose logits the step returns; a backward pass takes each
    product's gradient for every operand that needs one (none on the query
    and key paths when the softmax passes no gradient to its scores).
    ``impl_flops``: what the port's code computes, which the dry run's
    ``FlopCounterMode`` count equals on a contiguous cache without the
    card's row padding: ``flops`` plus ``excess_flops`` (scores of
    masked and empty cache positions, capacity rows, the SSD chunk form's
    products) plus ``remat_flops`` (the forward ``cfg.remat`` recomputes).

    ``bytes``, the least a step moves: every weight it touches read once
    (the embedding table: the rows it reads, unless tied; an MoE layer:
    every expert), each live key's cache entry moved once (the new one
    written, the rest read), the recurrent state read and written once,
    a prefill's cache entries written once, the inputs read and the
    logits written once; a train step reads and writes the f32 masters
    and the two AdamW moments once. Returns the counts, the roofline terms
    of the least work at the card's rates (``rate``, ``peak``) and
    ``bound_s``."""
    from repro_torch.models import kv_cache
    from repro_torch.models.model import Model

    if kind not in ("prefill", "decode", "generate", "train"):
        raise ValueError(f"unknown kind {kind!r}")
    cache_len = seq if cache_len is None else cache_len
    b = batch
    sg = kind == "train" and _score_grad(cfg)
    steps = max_new if kind == "generate" else 1
    step = kind in ("decode", "generate")
    window = cfg.window if cfg.family == "hybrid" else None
    encdec = cfg.family == "encdec"
    enc = (enc_len or seq) if encdec else 0
    # the query tokens a row; a step's live keys [steps, b]
    t = 1 if step else (dec_prompt if encdec and kind == "prefill" else seq)
    if step:
        if keys is None:
            keys = cache_len if kind == "decode" else cache_len - max_new + 1
        ks = np.broadcast_to(np.asarray(keys, np.int64), (b,))[None] + np.arange(steps)[:, None]
        if ks.max() > cache_len:
            raise ValueError(f"{int(ks.max())} live keys in a cache of {cache_len}")
        least_pairs = {"full": ks.sum() / steps,
                       "window": (np.minimum(ks, window) if window else ks).sum() / steps}
        impl_pairs = {"full": b * cache_len, "window": b * min(window or cache_len, cache_len)}
    else:
        least_pairs = {"full": _causal_pairs(b, t, None), "window": _causal_pairs(b, t, window)}
        impl_pairs = {"full": b * t * t, "window": b * t * t}

    def products(pairs, least):
        pr = _Products()
        if encdec:
            _encdec(pr, cfg, b, t, pairs["full"], enc, step, sg)
        else:
            _layers(pr, cfg, b, t, pairs, step, sg, least)
        _head(pr, cfg, b * t if kind == "train" else b)
        return pr

    least, impl = products(least_pairs, True), products(impl_pairs, False)
    if kind == "train":
        remat = {"full": impl.remat["mm"] + impl.remat["bmm"], "dots": impl.remat["bmm"],
                 "none": 0.0}[cfg.remat]
        flops, impl_flops = least.fwd + least.bwd, impl.fwd + impl.bwd + remat
    else:
        remat = 0.0
        flops, impl_flops = least.fwd * steps, impl.fwd * steps

    # bytes
    dt = params_dtype or (torch.float32 if kind == "train" else torch.bfloat16)
    params = Model(cfg, device="meta").init(dtype=dt)
    esz = _itemsize(dt)
    logit_bytes = 4 if cfg.logits_dtype == "float32" else 2
    if kind == "train":
        n_tok = b * seq
        weight = 6 * tree_bytes(params)     # masters and both moments, read and written
        io = n_tok * 8                      # tokens and labels (int32 each)
        if cfg.rope_type == "mrope":
            io += 3 * n_tok * 4
        if encdec:
            io += n_tok * cfg.d_model * 2
        state = 0
    else:
        rows_read = b * t
        rest = tree_bytes({k: v for k, v in params.items() if k != "embed"})
        embed = params["embed"]["w"]
        weight = steps * (rest + (embed.numel() * esz if cfg.tie_embeddings
                                  else rows_read * cfg.d_model * esz))
        # a cache position's bytes over every attention layer, global and
        # window; the recurrent state of a row over every SSD layer
        per_pos = (sum(int(np.prod(w)) * _itemsize(d_)
                       for w, d_ in kv_cache._leaves(cfg).values())
                   if cfg.family != "ssm" else 0)
        n_win = sum(kv_cache.hybrid_segments(cfg)) if window else 0
        n_full = cfg.n_layers - n_win if cfg.family != "ssm" else 0
        rec = (cfg.n_layers * tree_bytes(kv_cache._ssm_cache(1, 1, cfg, "meta"))
               if cfg.family in ("ssm", "hybrid") else 0)
        cross = per_pos * cfg.n_layers * b * enc
        if step:
            win_keys = (np.minimum(ks, window) if window else ks).sum()
            state = (per_pos * (n_full * int(ks.sum()) + n_win * int(win_keys))
                     + steps * (cross + 2 * b * rec))
            io = steps * (b * 8 + b * cfg.vocab * logit_bytes)
        else:
            # the prompt's cache entries written once (a window layer's
            # last ``window``), the recurrent state written
            state = (per_pos * b * (n_full * t + n_win * min(t, window or t))
                     + cross + b * rec)
            io = rows_read * 8 + b * cfg.vocab * logit_bytes
            if encdec:
                io += b * enc * cfg.d_model * 2
    nbytes = weight + state + io
    terms = roofline_terms(flops, nbytes, 0.0, peak_flops=peak, hbm_bw=rate)
    return {"kind": kind, "flops": flops, "impl_flops": impl_flops,
            "excess_flops": impl_flops - remat - flops, "remat_flops": remat,
            "bytes": float(nbytes), "weight_bytes": float(weight),
            "state_bytes": float(state), "io_bytes": float(io), "steps": steps, **terms}
