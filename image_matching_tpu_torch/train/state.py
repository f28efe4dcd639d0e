"""The train state of the port — the counterpart of
`image_matching_tpu/train/state.py`: the module (parameters and batch
statistics, updated in place), its optimizer and the step count."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, learning_rate: float = 1e-4) -> "TrainState":
        """Adam with `optax.adam`'s defaults (b1 0.9, b2 0.999, eps 1e-8,
        eps_root 0), whose update it equals: lr * m_hat / (sqrt(v_hat) + eps)."""
        opt = torch.optim.Adam(module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        return cls(module, opt)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in the parameters' `.grad`."""
        self.optimizer.step()
        self.step += 1
