"""Training-time validation (the reference's ``val:`` blocks; the port's
counterpart of the JAX package's ``train/validate.py``): every ``val_freq``
iterations, run the EMA generator over the val split, compute PSNR/SSIM
and save restored images.  (The JAX package's LPIPS and NIQE options wait
for the rest of eval.)

`make_val_fn` returns a ``val_fn(state, step) -> dict`` for
``Trainer.fit``.  Stage I validates the autoencoder's reconstruction of GT
clips; stages II–IV the restored middle frame of each LQ clip.

The EMA weights run in a second instance of the model, made once (a copy of
the trainer's) and loaded with ``load_state_dict`` at each call: the
training model is never touched, and the second instance stays in eval mode
with no gradient.  (Swapping EMA tensors into the training model would also
meet the kernel-weight cache of ``nn/blocks.py``, which is keyed on the live
parameters' version counters.)  Its forward runs under the trainer's
autocast, so on the card it launches the same kernels as training.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import numpy as np
import torch


def make_val_fn(stage_trainer, dataset, stage: str,
                max_samples: int = 8,
                save_dir: Optional[str] = None,
                w: float = 1.0) -> Callable:
    """Build a validation callback over a VFHQ dataset (one sample at a
    time, the EMA weights)."""
    from pgtformer_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim

    model = stage_trainer.model
    device = stage_trainer.device
    val_model = copy.deepcopy(model)
    for p in val_model.parameters():
        p.grad = None
    val_model.requires_grad_(False).eval()
    T = 2 * dataset.r + 1

    def fwd(clip: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(clip[None])).to(device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        with torch.no_grad(), stage_trainer._autocast():
            if stage == "I":
                out, _, _ = val_model(x)
            else:
                out, _, _ = val_model(x, w=w)
                out = out.reshape(1, T, *out.shape[1:])[:, T // 2]
        return out.float().clamp(0.0, 1.0).cpu().numpy()

    idxs = list(range(0, len(dataset),
                      max(1, len(dataset) // max(1, max_samples))))
    idxs = idxs[:max_samples]

    def val_fn(state, step: int) -> dict:
        sd = dict(model.state_dict())
        sd.update(state.g.ema_params)
        val_model.load_state_dict(sd, strict=True)

        rows = []
        for i in idxs:
            sample = dataset[i]
            if stage == "I":
                target = sample["gt"]          # [T, H, W, 3]
                out = fwd(sample["gt"]).reshape(target.shape)
                pairs = [(out[t], target[t]) for t in range(T)]
            else:
                target = sample["gt"][T // 2]
                out = fwd(sample["lq"])[0]
                pairs = [(out, target)]

            rows.append({"psnr": float(np.mean([calculate_psnr(a, b)
                                                for a, b in pairs])),
                         "ssim": float(np.mean([calculate_ssim(a, b)
                                                for a, b in pairs]))})

            if save_dir is not None:
                import cv2
                d = os.path.join(save_dir, f"iter_{step}")
                os.makedirs(d, exist_ok=True)
                img = pairs[0][0]
                name = sample["path"].replace("/", "_")
                cv2.imwrite(os.path.join(d, name),
                            (np.clip(img[..., ::-1], 0, 1)
                             * 255).astype(np.uint8))

        return {k: float(np.mean([r[k] for r in rows]))
                for k in rows[0].keys()}

    return val_fn
