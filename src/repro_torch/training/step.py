"""The train step: loss and gradients, optional microbatch accumulation
and bf16 gradient compression with error feedback, then AdamW (port of
``src/repro/training/step.py``).

Parameters are f32 master weights (``Model.init(dtype=torch.float32)`` or
``convert.params_from_numpy(..., dtype=torch.float32)``); the forward
casts each weight to the model's compute dtype where it uses it, as the
reference's. A leaf that gets no gradient from autograd gets zeros, as
JAX gives it: under the integer softmax the rounding of Alg. 1 passes no
gradient to the scores, so the query and key projections (MLA's query and
key paths too) get zeros, and weight decay and the moments' decay still
apply to them. A softmax backend that cannot be differentiated (the CUDA
kernel behind ``int_pallas``, ``ap_sim``) raises here: train against a
differentiable spec (``fp``, ``int``, ``int_ste``) and serve with the
other, as the launchers do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.softmax_variants import spec_backend
from repro_torch.models.kv_cache import tree_leaves, tree_map
from repro_torch.training.grad_compression import compress, decompress, init_error_feedback
from repro_torch.training.loss import softmax_xent
from repro_torch.training.optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    params: object
    opt: AdamWState
    error_fb: Optional[object]  # grad-compression residual (or None)


def init_state(model, opt: AdamW, generator: Optional[torch.Generator] = None,
               grad_compress: bool = False) -> TrainState:
    """f32 master weights from ``model.init`` (``generator``: seed 0 when
    None), fresh moments and, with ``grad_compress``, a zero residual."""
    params = model.init(generator, dtype=torch.float32)
    ef = init_error_feedback(params) if grad_compress else None
    return TrainState(params, opt.init(params), ef)


def to_device(batch, device):
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _split(x, mb: int):
    """The reference's microbatch rule: the leading axis when ``mb``
    divides it (tokens, labels, frames), else M-RoPE's [3, B, S] positions
    along B. Returns the ``mb`` pieces."""
    if x.ndim >= 2 and x.shape[0] % mb == 0:
        return list(x.reshape(mb, x.shape[0] // mb, *x.shape[1:]))
    if x.ndim == 3 and x.shape[1] % mb == 0:
        return list(x.reshape(x.shape[0], mb, x.shape[1] // mb, x.shape[2]).transpose(0, 1))
    raise ValueError(f"cannot microbatch shape {tuple(x.shape)}")


def make_grad_fn(model, microbatches: int = 0):
    """``grads_of(params, batch) -> (grads, metrics)``: the gradients of
    ``softmax_xent(train_logits) + aux`` (f32 for f32 parameters; zeros
    where autograd gives none) and the metrics {"loss", "accuracy",
    "tokens", "aux_loss"}. With ``microbatches`` > 1 the batch is split by
    the reference's rule and the gradients and metrics are averaged over
    the pieces, the gradients summed in f32 in piece order."""
    backend = spec_backend(model.cfg.softmax)
    if not backend.differentiable:
        raise ValueError(
            f"softmax backend {backend.name!r} cannot be differentiated: train "
            "against a differentiable spec (fp, int, int_ste) and serve with this one")

    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch)
        loss, metrics = softmax_xent(logits, batch["labels"])
        metrics["aux_loss"] = aux
        return loss + aux, metrics

    def value_and_grad(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(leaves)
        with torch.enable_grad():
            total, metrics = loss_fn(leaves, batch)
        got = iter(torch.autograd.grad(total, flat, allow_unused=True))
        grads = tree_map(lambda p: _or_zeros(next(got), p), leaves)
        return grads, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}

    def grads_of(params, batch):
        batch = to_device(batch, model.device)
        if not (microbatches and microbatches > 1):
            return value_and_grad(params, batch)
        pieces = {k: _split(v, microbatches) for k, v in batch.items()}
        gsum, ms = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params), []
        for i in range(microbatches):
            g, m = value_and_grad(params, {k: v[i] for k, v in pieces.items()})
            gsum = tree_map(torch.add, gsum, g)
            ms.append(m)
        grads = tree_map(lambda g: g / microbatches, gsum)
        metrics = {k: torch.stack([m[k].to(torch.float32) for m in ms]).mean()
                   for k in ms[0]}
        return grads, metrics

    return grads_of


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def make_train_step(model, opt: AdamW, grad_compress: bool = False,
                    microbatches: int = 0):
    """``train_step(state, batch) -> (state, metrics)``. ``batch``:
    {"tokens": [B, S], "labels": [B, S]} plus the family's extras
    ("positions" [3, B, S] for M-RoPE, "frames" for the encoder-decoder),
    numpy or tensors. The metrics add "grad_norm" (before clipping) and
    "lr" to :func:`make_grad_fn`'s."""
    grads_of = make_grad_fn(model, microbatches)

    def train_step(state: TrainState, batch):
        grads, metrics = grads_of(state.params, batch)
        ef = state.error_fb
        if grad_compress:
            # the bf16 payload an all-reduce would move; the f32 residual
            # is folded into the next step
            payload, ef = compress(grads, ef)
            grads = decompress(payload)
        params, opt_state, gnorm = opt.update(grads, state.opt, state.params)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = opt.lr(opt_state.step)
        return TrainState(params, opt_state, ef), metrics

    return train_step
