"""The train state of the port — the counterpart of
`image_matching_tpu/train/state.py`: the module (parameters and batch
statistics, updated in place), its optimizer and the step count.

The optimizer is the chain the JAX training CLI builds
(`image_matching_tpu/cli/train_superglue.py:149-159`): an optional global
norm clip, then Adam with a constant, warmed-up or cosine-decayed
learning rate, computed as optax computes it, in its float32 order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


def learning_rate_schedule(learning_rate: float, warmup_steps: int = 0, cosine_decay_steps: int = 0):
    """The learning rate of the update after `count` updates, as the JAX CLI
    chooses it: `optax.linear_schedule(0, lr, warmup_steps)` if
    warmup_steps > 0 (lr 0 at the first update), else
    `optax.cosine_decay_schedule(lr, cosine_decay_steps, alpha=0.1)` (lr / 10
    from step cosine_decay_steps on) if cosine_decay_steps > 0, else lr.
    The two are exclusive: with both set, warmup wins and no decay follows."""
    if warmup_steps > 0:
        return lambda count: (0.0 - learning_rate) * (1 - min(max(count, 0), warmup_steps) / warmup_steps) \
            + learning_rate
    if cosine_decay_steps > 0:
        return lambda count: learning_rate * (
            0.9 * 0.5 * (1 + math.cos(math.pi * min(count, cosine_decay_steps) / cosine_decay_steps)) + 0.1)
    return lambda count: learning_rate


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> None:
    """`optax.clip_by_global_norm` in place: where the global norm of all
    gradients is at least `max_norm`, each becomes (g / norm) * max_norm
    (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`). No host sync."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def _float32_power(base: float, count: int) -> float:
    """base ** count as a float32 power on the CPU (XLA's float32 pow gives
    the same value over an optimizer's early counts, where 1 - b2^t is
    small and one ulp of it matters)."""
    return float(torch.tensor(base, dtype=torch.float32) ** torch.tensor(float(count)))


class Adam(torch.optim.Optimizer):
    """`optax.adam` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), update for
    update and in optax's float32 arithmetic: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t))
    + eps) with t the count after this update and each bias correction
    1 - b^t rounded to float32 (torch's Adam corrects in float64, a relative
    difference of up to 1e-5 in the first updates), then p += (-lr) u.
    Per parameter its state holds `mu` and `nu`; the group holds `count`."""

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            grads = [p.grad for p in params]
            mu, nu = [self.state[p]["mu"] for p in params], [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            group["count"] += 1
            bc1 = 1 - _float32_power(b1, group["count"])
            bc2 = 1 - _float32_power(b2, group["count"])
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_mul_(update, -group["lr"])
            torch._foreach_add_(params, update)


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    optimizer: Adam
    step: int = 0
    learning_rate: float = 1e-4
    warmup_steps: int = 0
    cosine_decay_steps: int = 0
    grad_clip: float = 0.0

    @classmethod
    def create(cls, module: nn.Module, learning_rate: float = 1e-4, warmup_steps: int = 0,
               cosine_decay_steps: int = 0, grad_clip: float = 0.0) -> "TrainState":
        """`Adam` at the rate of `learning_rate_schedule`, after a clip of
        the gradients to the global norm `grad_clip` where that is > 0."""
        return cls(module, Adam(module.parameters(), learning_rate), 0, learning_rate, warmup_steps,
                   cosine_decay_steps, grad_clip)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after `count` updates."""
        return learning_rate_schedule(self.learning_rate, self.warmup_steps, self.cosine_decay_steps)(count)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in the parameters' `.grad`."""
        if self.grad_clip > 0:
            clip_by_global_norm([p.grad for p in self.module.parameters() if p.grad is not None], self.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self.step)
        self.optimizer.step()
        self.step += 1
