"""Mamba2 / SSD (state-space duality) block (port of
``src/repro/models/ssm.py``)  [arXiv:2405.21060].

Prefill runs the chunked SSD algorithm: a quadratic, attention-like term
inside chunks of ``cfg.ssm_chunk`` tokens and a linear state recurrence
across chunks (a Python loop over the chunks in place of ``lax.scan``).
Decode is the O(1) recurrent update of the [B, H, P, N] state, written in
place into the layer's cache; the speculative verify step runs that update
once per token and keeps a snapshot after each.

Layout: d_inner = expand * d_model = H * P heads; the B / C projections
have G groups of state size N; a depthwise causal conv (k = ``ssm_conv``)
runs over the [x, B, C] features. Dtypes are the reference's: the state in
f32, the conv tail in the cache's dtype, the chunk products in the compute
dtype, every multi-operand einsum contracted pairwise in a fixed order with
each intermediate rounded to the compute dtype.

The reference computes all of this in plain ``jnp`` (no Pallas kernel), so
the port computes it in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Ctx, dense_apply, norm_apply


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(p, x, cfg, ctx: Ctx):
    di, n, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_nheads
    zxbcdt = dense_apply(p["in_proj"], x, ctx)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, ctx: Ctx):
    """Depthwise causal conv over time, xbc [B, L, C]: the k taps summed in
    the reference's order (``sum`` over k, each term and partial sum in the
    compute dtype), then SiLU."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = None
    for i in range(k):
        term = pad[:, i:i + l, :] * ctx.cast(w[i])
        out = term if out is None else out + term
    return F.silu(out + ctx.cast(b))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD chunked scan. x [b, l, h, p], dt [b, l, h], A [h] (f32, the
    log-decay), B / C [b, l, g, n]. Returns (y [b, l, h, p], final state
    [b, h, p, n] f32). A sequence longer than ``chunk`` must be a whole
    number of chunks, as in the reference (whose assertion this raises)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, l)
    if l % q != 0:
        raise ValueError(
            f"SSD chunk grid: a sequence of {l} tokens longer than ssm_chunk {chunk} "
            f"must be a multiple of it (the reference asserts l % min(chunk, l) == 0)")
    nc = l // q
    rep = h // g
    xs = x.reshape(b, nc, q, h, p)
    dts = dt.reshape(b, nc, q, h)
    Bs = B.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)   # [b,nc,q,h,n]
    Cs = C.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)

    dA = dts.to(torch.float32) * (-torch.exp(A))                    # [b,nc,q,h] f32
    seg = torch.cumsum(dA, dim=2)

    # intra-chunk: y_ij = C_i . B_j * exp(seg_i - seg_j) * dt_j; the masked
    # (j > i) entries are clamped to -30 before exp, as the reference
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]              # [b,nc,qi,qj,h]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    li = torch.where(causal, li, torch.full((), -30.0, device=x.device))
    decay = torch.where(causal, torch.exp(li), torch.zeros((), device=x.device))
    cb = torch.einsum("bcqhn,bcshn->bcqsh", Cs, Bs)
    cbd = cb * decay.to(cb.dtype)                                   # bcqsh
    dx = dts.to(cb.dtype)[..., None] * xs                           # bcshp
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", cbd, dx)

    # chunk states: S_c = sum_j exp(seg_last - seg_j) * dt_j * B_j x_j^T
    last = seg[:, :, -1:, :]
    w_state = torch.exp(last - seg) * dts                           # f32
    wb = w_state.to(xs.dtype)[..., None] * Bs                       # bcqhn
    S_c = torch.einsum("bcqhn,bcqhp->bchpn", wb, xs).to(torch.float32)
    chunk_decay = torch.exp(last[:, :, 0, :]).to(torch.float32)     # [b,nc,h]

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)                                          # state before chunk c
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    prev_states = torch.stack(prev, dim=1)                          # [b,nc,h,p,n]

    # inter-chunk: y_i += C_i . state_prev * exp(seg_i)
    cs = torch.einsum("bcqhn,bchpn->bcqhp", Cs, prev_states.to(xs.dtype))
    y_off = cs * torch.exp(seg).to(xs.dtype)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state


def ssm_apply(p, x_in, cfg, ctx: Ctx, return_state: bool = False):
    """Full-sequence SSD, x_in [B, L, d]. With ``return_state`` also the
    decode cache {"state": [B, H, P, N] f32, "conv": [B, k-1, C]}: the
    last k-1 pre-conv feature rows, zero-padded when the prompt is
    shorter."""
    b, l, _ = x_in.shape
    di, n, g, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_nheads, cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(p, x_in, cfg, ctx)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"], ctx)
    xs = xbc[..., :di].reshape(b, l, h, ph)
    B = xbc[..., di:di + g * n].reshape(b, l, g, n)
    C = xbc[..., di + g * n:].reshape(b, l, g, n)
    dtv = _softplus(dt.to(torch.float32) + p["dt_bias"]).to(ctx.dtype)
    y, state = ssd_chunked(xs, dtv, p["A_log"], B, C, cfg.ssm_chunk)
    y = y + xs * ctx.cast(p["D"])[None, None, :, None]
    y = y.reshape(b, l, di) * F.silu(z)
    y = norm_apply(p["gate_norm"], y, "rmsnorm", ctx)
    out = dense_apply(p["out_proj"], y, ctx)
    if return_state:
        k1 = cfg.ssm_conv - 1
        tail = torch.cat([torch.zeros((b, k1, xbc_raw.shape[-1]), dtype=xbc_raw.dtype,
                                      device=xbc_raw.device), xbc_raw], 1)[:, -k1:]
        return out, {"state": state, "conv": tail}
    return out


def ssm_decode(p, x_in, cache, cfg, ctx: Ctx):
    """One-token recurrent update, x_in [B, 1, d]; cache {"state": [B, H, P,
    N], "conv": [B, k-1, C]} written in place. Returns (y [B, 1, d],
    cache)."""
    b = x_in.shape[0]
    di, n, g, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_nheads, cfg.ssm_head_dim
    z, xbc_new, dt = _split_proj(p, x_in, cfg, ctx)
    conv_in = torch.cat([cache["conv"], xbc_new.to(cache["conv"].dtype)], 1)   # [B, k, C]
    w = ctx.cast(p["conv_w"])
    # the reference's einsum("bkc,kc->bc") in the compute dtype: products
    # summed over k with one rounding
    acc = (conv_in.to(ctx.dtype).to(torch.float32) * w.to(torch.float32)).sum(1)
    xbc = F.silu(acc.to(ctx.dtype) + ctx.cast(p["conv_b"]))[:, None, :]
    xs = xbc[..., :di].reshape(b, h, ph)
    B = xbc[..., di:di + g * n].reshape(b, g, n).repeat_interleave(h // g, dim=1)
    C = xbc[..., di + g * n:].reshape(b, g, n).repeat_interleave(h // g, dim=1)
    dtv = _softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]                 # [B, H]
    dA = torch.exp(dtv * (-torch.exp(p["A_log"])))
    state = cache["state"].to(torch.float32)
    upd = (dtv[:, :, None] * B.to(torch.float32))[:, :, None, :] * xs.to(torch.float32)[..., None]
    state = state * dA[:, :, None, None] + upd                                 # [B,H,P,N]
    y = torch.einsum("bhn,bhpn->bhp", C.to(torch.float32), state).to(ctx.dtype)
    y = y + xs * ctx.cast(p["D"])[None, :, None]
    y = y.reshape(b, 1, di) * F.silu(z)
    y = norm_apply(p["gate_norm"], y, "rmsnorm", ctx)
    cache["state"].copy_(state.to(cache["state"].dtype))
    cache["conv"].copy_(conv_in[:, 1:])
    return dense_apply(p["out_proj"], y, ctx), cache


def ssm_verify(p, x_in, cache, cfg, ctx: Ctx):
    """T-token recurrent update with a snapshot after every token (the
    speculative verify step): the state after T tokens has folded all of
    them in, so a rejected draft is undone by restoring the snapshot at the
    accepted depth (``kv_cache.commit_staged``), not by masking. ``x_in``
    [B, T, d] (normalized). The cache is stepped in place (it ends at the
    last token). Returns (y [B, T, d], staged {"state": [T, B, H, P, N],
    "conv": [T, B, k-1, C]})."""
    from repro_torch.backends import telemetry

    t = x_in.shape[1]
    ys, states, convs = [], [], []
    for i in telemetry.scan_range(t):
        # contiguous, as a decode step's input: the product then runs the
        # decode step's kernel on the same layout
        y, cache = ssm_decode(p, x_in[:, i:i + 1].contiguous(), cache, cfg, ctx)
        ys.append(y)
        states.append(cache["state"].clone())
        convs.append(cache["conv"].clone())
    return torch.cat(ys, dim=1), {"state": torch.stack(states), "conv": torch.stack(convs)}
