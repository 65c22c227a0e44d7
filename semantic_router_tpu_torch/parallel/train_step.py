"""The LoRA training step on one device (the port of
``semantic_router_tpu.parallel.train_step`` without its mesh).

The base is frozen: ``make_lora_optimizer`` sets ``requires_grad=False``
on every parameter ``lora_param_filter`` does not pick, and hands only the
adapters to ``torch.optim.AdamW`` (optax's ``b1``, ``b2``, ``eps`` and
``weight_decay=0.01``).  torch's AdamW decays first, ``p ← p(1 − lr·wd)``,
then takes the Adam step; optax's ``adamw`` adds ``−lr·wd·p`` to the same
step.  Both give ``p − lr·(adam + wd·p)`` on the adapters alone, which is
what ``optax.multi_transform`` with ``set_to_zero`` on the base computes.
The step runs forward, loss and backward eagerly on the module's device:
dense attention, as the JAX training path (the flash kernel has no
backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``
    (softmax in float32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def trainable_parameters(module: nn.Module,
                         trainable_filter: Optional[Callable] = None) -> list:
    """Freeze every parameter of ``module`` the filter does not pick
    (``lora_param_filter`` when None) and return the picked ones, in name
    order."""
    if trainable_filter is None:
        from ..models.lora import lora_param_filter
        trainable_filter = lora_param_filter
    picked = []
    for name, p in sorted(module.named_parameters()):
        keep = bool(trainable_filter(name, p))
        p.requires_grad_(keep)
        if keep:
            picked.append(p)
    if not picked:
        raise ValueError(f"{type(module).__name__} has no trainable "
                         f"parameter under the filter")
    return picked


def make_lora_optimizer(module: nn.Module, learning_rate: float = 1e-4,
                        weight_decay: float = 0.01,
                        trainable_filter: Optional[Callable] = None
                        ) -> torch.optim.AdamW:
    """AdamW over ``module``'s adapter parameters only; the base frozen."""
    return torch.optim.AdamW(
        trainable_parameters(module, trainable_filter), lr=learning_rate,
        betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def make_train_step(apply_fn: Callable,
                    optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = cross_entropy_loss):
    """Build (init_state, step).

    ``apply_fn(module, input_ids, attention_mask) → logits``.
    ``init_state(module)`` pairs the module with ``optimizer`` (built over
    that module's adapters); ``step(state, input_ids, attention_mask,
    labels)`` computes the loss, its gradients and the optimizer's update
    in place and returns {"loss", "accuracy"} as 0-d tensors on the
    device (reading them synchronizes)."""
    def init_state(module: nn.Module) -> TrainState:
        owned = {id(p) for p in module.parameters()}
        for group in optimizer.param_groups:
            for p in group["params"]:
                if id(p) not in owned:
                    raise ValueError("the optimizer holds a parameter the "
                                     "module does not")
        return TrainState(module.train(), optimizer)

    def step(state: TrainState, input_ids: torch.Tensor,
             attention_mask: torch.Tensor, labels: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        logits = apply_fn(state.module, input_ids, attention_mask)
        loss = loss_fn(logits, labels)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return init_state, step

