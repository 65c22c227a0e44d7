"""The shared LoRA training loop: optimizer, step, history (the port of
``semantic_router_tpu.training.loop`` on one device).

The sequence and token fine-tunes both delegate here.  A ``mesh_shape``
whose axes multiply to more than one device is refused: the mesh is not
ported."""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn


def run_lora_training(apply_fn: Callable, module: nn.Module,
                      iterator: Iterator[Tuple],
                      num_steps: int, learning_rate: float,
                      mesh_shape: Optional[Dict[str, int]] = None,
                      loss_fn: Optional[Callable] = None,
                      log_every: int = 20,
                      track_accuracy: bool = True
                      ) -> Tuple[nn.Module, List[Dict[str, float]]]:
    """``apply_fn(module, ids, mask) → logits``; ``iterator`` yields
    (ids, mask, labels) numpy batches, moved to the module's device.
    Trains ``module``'s adapters in place and returns (module, history):
    one {"step", "loss", "wall_s"[, "accuracy"]} entry every ``log_every``
    steps and at the last."""
    from ..parallel import make_lora_optimizer, make_train_step

    n = math.prod(int(v) for v in (mesh_shape or {}).values())
    if n > 1:
        raise ValueError(f"mesh_shape {dict(mesh_shape)} spans {n} devices: "
                         f"the training mesh is not ported, this port "
                         f"trains on one device")
    kwargs = {"loss_fn": loss_fn} if loss_fn is not None else {}
    init_state, step = make_train_step(
        apply_fn, make_lora_optimizer(module, learning_rate), **kwargs)
    state = init_state(module)
    device = next(module.parameters()).device
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        ids, mask, labels = next(iterator)
        metrics = step(state,
                       torch.from_numpy(ids).to(device),
                       torch.from_numpy(mask).to(device),
                       torch.from_numpy(labels).long().to(device))
        if (i + 1) % log_every == 0 or i == num_steps - 1:
            entry = {"step": i + 1,
                     "loss": float(metrics["loss"]),
                     "wall_s": time.perf_counter() - t0}
            if track_accuracy and "accuracy" in metrics:
                entry["accuracy"] = float(metrics["accuracy"])
            history.append(entry)
    module.eval()
    return module, history
