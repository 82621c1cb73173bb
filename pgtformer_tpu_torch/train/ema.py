"""EMA of the generator's parameters (reference ``ema_decay: 0.999``,
checkpoints keyed ``params_ema``), as the JAX package's ``train/ema.py``."""

from __future__ import annotations

from typing import Dict

import torch


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 copies of `params`."""
    return {k: p.detach().float().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """ema = decay * ema + (1 - decay) * params, in place over every key
    (frozen parameters too, as in JAX); returns `ema_params`."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[k].detach().float() for k in keys], alpha=1.0 - decay)
    return ema_params
