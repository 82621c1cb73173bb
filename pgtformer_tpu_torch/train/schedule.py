"""LR schedule and optimizer: MultiStepLR with linear warm-up, and Adam
with betas (0.5, 0.9) (the JAX package's ``train/schedule.py``; reference
options/*.yml ``scheduler: MultiStepLR`` + ``warmup_iter``)."""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import torch


def multistep_with_warmup(base_lr: float, milestones: Sequence[int], gamma: float = 0.5,
                          warmup_iter: int = -1) -> Callable[[int], float]:
    """lr(count), count = optimizer steps taken before this one: base_lr *
    gamma^(milestones passed), ramped linearly from exactly 0 over
    `warmup_iter` steps when warmup_iter > 0.  As with optax's
    ``join_schedules``, the milestones count from the warm-up's end."""
    ms = sorted(int(m) for m in milestones)

    def multistep(count: int) -> float:
        return base_lr * gamma ** sum(count >= m for m in ms)

    if not (warmup_iter and warmup_iter > 0):
        return multistep

    def schedule(count: int) -> float:
        if count < warmup_iter:
            return base_lr * count / warmup_iter
        return multistep(count - warmup_iter)

    return schedule


def make_adam(params: Iterable[torch.Tensor], schedule: Callable[[int], float],
              betas: Tuple[float, float] = (0.5, 0.9)):
    """(Adam over `params` with eps 1e-8, a LambdaLR stepping `schedule`).
    The optimizer's base lr is 1, so the lambda's value is the lr itself;
    call ``scheduler.step()`` after each ``optimizer.step()``."""
    opt = torch.optim.Adam(params, lr=1.0, betas=tuple(betas), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
