"""Train state of the four-stage recipe (the JAX package's ``train/state.py``
names, torch contents).

The tensors are the trainer's own: ``params`` maps each parameter name to
the module's live fp32 parameter, ``codebook`` and ``batch_stats`` to the
module's buffers, and a step updates them in place (no second copy of the
model is kept).  ``opt_state`` is the optimizer's ``state_dict()``, taken
after each step.  The state is therefore bound to the trainer that made it
(``init_state``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass
class GeneratorState:
    """Generator side: fp32 master parameters (trainable and frozen, not the
    codebooks), their fp32 EMA, the optimizer's state_dict, the codebook
    buffers (EMA-updated in stage I, frozen later) and the parsing prior's
    frozen BatchNorm statistics."""
    params: Tensors
    ema_params: Tensors
    opt_state: Dict[str, Any]
    codebook: Optional[Tensors] = None
    batch_stats: Optional[Tensors] = None


@dataclass
class DiscriminatorState:
    params: Tensors
    opt_state: Dict[str, Any]
    batch_stats: Optional[Tensors] = None    # PatchGAN BN running statistics


@dataclass
class TrainState:
    """`step` counts the steps taken; `rng` (on the trainer's device) draws
    the codebook restarts."""
    step: int
    g: GeneratorState
    d: Optional[DiscriminatorState]
    rng: torch.Generator
