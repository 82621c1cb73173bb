"""Training losses of the four-stage recipe (the JAX package's
``train/losses.py``: reconstructions from the reference YAMLs' signatures,
the reference's loss classes being absent).  Pure functions over
channels-last tensors; video losses take [B, T, H, W, C].  Each computes in
fp32."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def l1_loss(pred, target, loss_weight: float = 1.0) -> torch.Tensor:
    return loss_weight * (pred.float() - target.float()).abs().mean()


def mse_loss(pred, target, loss_weight: float = 1.0) -> torch.Tensor:
    d = pred.float() - target.float()
    return loss_weight * (d * d).mean()


def grad_l1_loss(pred, target, loss_weight: float = 1.0,
                 lossmulti: Sequence[float] = (0.2, 0.05, 0.05), tf: int = 3) -> torch.Tensor:
    """L1 plus the L1 of the temporal differences of each ordered frame pair
    ((0,1), (1,2), (0,2) for tf=3) weighted by `lossmulti` (stage IV's
    ``GRADL1Loss``)."""
    total = (pred.float() - target.float()).abs().mean()
    pairs = [(i, j) for i in range(tf) for j in range(i + 1, tf)]
    for w, (i, j) in zip(lossmulti, pairs):
        dp = pred[:, j] - pred[:, i]
        dt = target[:, j] - target[:, i]
        total = total + w * (dp.float() - dt.float()).abs().mean()
    return loss_weight * total


def _log_p_target(logits, codes):
    logp = F.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, codes[..., None]).squeeze(-1)


def cross_entropy_loss(logits, codes, loss_weight: float = 1.0) -> torch.Tensor:
    """Token CE: logits [..., n_embed], codes [...] int."""
    return loss_weight * (-_log_p_target(logits, codes)).mean()


def focal_loss(logits, codes, loss_weight: float = 1.0, gamma: float = 2.0,
               alpha: Optional[float] = None) -> torch.Tensor:
    """Focal cross-entropy over code logits (stage IV's token loss)."""
    logp_t = _log_p_target(logits, codes)
    focal = -((1.0 - logp_t.exp()) ** gamma) * logp_t
    if alpha is not None:
        focal = alpha * focal
    return loss_weight * focal.mean()


class HingeGANLoss:
    """taming-transformers hinge GAN loss ("TanmingGANLoss" in the YAMLs),
    or the vanilla softplus one."""

    def __init__(self, gan_type: str = "hinge", loss_weight: float = 1.0):
        if gan_type not in ("hinge", "vanilla"):
            raise ValueError(f"gan_type {gan_type!r} (choices: hinge, vanilla)")
        self.gan_type = gan_type
        self.loss_weight = loss_weight

    def g_loss(self, fake_logits) -> torch.Tensor:
        f = fake_logits.float()
        if self.gan_type == "hinge":
            return -f.mean() * self.loss_weight
        return F.softplus(-f).mean() * self.loss_weight

    def d_loss(self, real_logits, fake_logits) -> torch.Tensor:
        r, f = real_logits.float(), fake_logits.float()
        if self.gan_type == "hinge":
            return 0.5 * (F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean())
        return 0.5 * (F.softplus(-r).mean() + F.softplus(f).mean())


def temporal_lpips_loss(lpips_fn: Callable, pred, target, temporal: int = 3,
                        tgrad_weight: float = 0.8) -> torch.Tensor:
    """LPIPS + tgrad_weight * LPIPS of the temporal differences (stage IV's
    ``TemporalLPIPSLoss``).  pred/target [B, T, H, W, C] in [0, 1];
    `lpips_fn` maps two [N, H, W, C] batches to per-sample distances."""
    B, T = pred.shape[:2]
    flat = lambda x: x.reshape(B * T, *x.shape[2:])
    base = lpips_fn(flat(pred), flat(target)).mean()
    dp = pred[:, 1:] - pred[:, :-1]
    dt = target[:, 1:] - target[:, :-1]
    n = B * (T - 1)
    tg = lpips_fn(dp.reshape(n, *dp.shape[2:]), dt.reshape(n, *dt.shape[2:])).mean()
    return base + tgrad_weight * tg
