"""Training step: next-token cross-entropy (+ the model's aux loss), grads,
AdamW; and the draft distillation step (``repro.training.train_step``).

Used by the training launcher (``launch/train.py``), the CPU parity tests
and ``chip_smoke.py``'s training phase.  The functions keep the JAX
package's signatures and metric names (``loss``, ``ce``, ``aux``,
``grad_norm``, ``kl``).  Metrics are 0-d tensors on the device; a caller
reads them with an explicit ``.cpu()`` at step boundaries.

A step computes the gradients with ``torch.autograd.grad`` against detached
views of the parameters (so the caller's tensors never acquire
``requires_grad``), then updates them in place (``adamw_update``).  The
forward keeps every layer's activations: the JAX package's remat policy
has no counterpart here (``remat`` is accepted for the signature).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, adamw_update,
                                            leaves, tree_map)

Params = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL.  logits [B,T,V] fp32; labels [B,T] int."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def make_loss_fn(model, cfg: ModelConfig, remat: bool = True,
                 extra_keys: Tuple[str, ...] = ()):
    """loss(params, batch) -> (loss, metrics).  batch: tokens [B,T+1] (plus
    optional ``labels``, ``mask`` and the ``extra_keys`` the forward takes)."""

    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        inputs = tokens[:, :-1]
        labels = batch.get("labels", tokens[:, 1:])
        kw = {k: batch[k] for k in extra_keys if k in batch}
        logits, aux = model.forward(params, inputs, **kw)
        if logits.shape[1] != inputs.shape[1]:
            logits = logits[:, logits.shape[1] - inputs.shape[1]:]
        ce = cross_entropy(logits, labels, batch.get("mask"))
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params: Params, batch) -> Tuple[Dict, Params]:
    """(metrics, grads) of ``loss_fn(params, batch)``; the grads are a tree
    with the parameters' keys, computed against detached views of them."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        flat = list(leaves(live))
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    order = {id(t): next(it) for t in flat}
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: order[id(p)], live))


def make_train_step(model, cfg: ModelConfig, opt: AdamWConfig,
                    remat: bool = True, extra_keys: Tuple[str, ...] = ()):
    """Returns train_step(params, opt_state, batch) -> (params', opt_state',
    metrics); the parameters and moments are updated in place."""
    loss_fn = make_loss_fn(model, cfg, remat, extra_keys)

    def train_step(params: Params, opt_state: AdamWState, batch):
        metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, gnorm = adamw_update(opt, grads, opt_state, params)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_eval_step(model, cfg: ModelConfig, extra_keys: Tuple[str, ...] = ()):
    loss_fn = make_loss_fn(model, cfg, remat=False, extra_keys=extra_keys)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# draft distillation: train the draft on the target's logits, so that its
# acceptance l(s) is not zero (the paper's "the SSM must mimic the LLM")


def make_distill_loss_fn(draft_model, temperature: float = 1.0):
    """KL(target || draft) on the same token stream.  batch: {tokens
    [B,T+1], teacher_logits [B,T,V]}."""

    def loss_fn(params, batch):
        inputs = batch["tokens"][:, :-1]
        logits, _ = draft_model.forward(params, inputs)
        tl = batch["teacher_logits"]
        t = torch.log_softmax(tl / temperature, dim=-1)
        d = torch.log_softmax(logits[..., :tl.shape[-1]], dim=-1)
        kl = (torch.exp(t) * (t - d)).sum(-1).mean()
        return kl, {"kl": kl}

    return loss_fn


def make_distill_step(draft_model, cfg: ModelConfig, opt: AdamWConfig,
                      temperature: float = 1.0):
    """step(params, opt_state, batch) -> (params', opt_state', metrics) with
    metrics ``kl`` and ``grad_norm``; updates in place."""
    loss_fn = make_distill_loss_fn(draft_model, temperature)

    def step(params, opt_state, batch):
        metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, gnorm = adamw_update(opt, grads, opt_state, params)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return step
