"""AdamW with the JAX package's exact semantics (``repro.training.optimizer``).

Not ``torch.optim.AdamW``: that one decays the parameter outside the
normalized step and clips nothing.  Here, as in the JAX package, the
gradients are first clipped by their global norm, the decay is added inside
``delta`` (``lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), and the moments
are fp32 whatever the parameters' dtype.

Parameters, gradients and moments are nested dicts of tensors with the
parameters' keys.  The step counter is a 0-d int32 tensor on the
parameters' device and the schedule is computed there, so an update reads
nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, NamedTuple, Tuple

import torch

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    m: Params
    v: Params


def leaves(tree: Params) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in key order (the JAX tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_adamw(params: Params) -> AdamWState:
    """Zero fp32 moments beside each parameter, step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    dev = next(leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                      v=tree_map(torch.clone, zeros))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr``; ``step`` a 0-d
    tensor, the result fp32 on its device."""
    step_f = step.to(torch.float32)
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step_f - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState, torch.Tensor]:
    """One AdamW step with global-norm clipping; returns ``(params', state',
    gnorm)``.  Unlike the JAX function it updates in place, under
    ``torch.no_grad()``: the parameter tensors and the moment tensors of
    ``state`` are overwritten and returned, so no second copy of the
    parameters and moments is ever held."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1t = 1.0 - cfg.b1 ** step_f
    b2t = 1.0 - cfg.b2 ** step_f

    def upd(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        return p

    params = tree_map(upd, params, grads, state.m, state.v)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
