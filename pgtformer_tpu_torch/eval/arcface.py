"""ArcFace identity embedder (IResNet-50) for metric-grade Deg (the port's
copy of the JAX package's ``eval/arcface.py``).

The reference reports the identity-degradation metric "Deg" (README.md:127)
but ships no implementation; the community standard is the angle between
ArcFace embeddings of pred/GT faces (insightface `arcface_torch`,
`iresnet50` backbone, 112x112 aligned crops).  This module provides:

  * :class:`IResNet`, the inference path of the public `arcface_torch`
    architecture (BatchNorm on running statistics, per-channel PReLU) with
    its parameter names, so a released `backbone.pth` (e.g.
    ms1mv3_arcface_r50) loads with a strict ``load_state_dict``
    (``num_batches_tracked`` ignored);
  * :func:`arcface_state_dict_from_flax`, which carries the JAX package's
    IResNet variables into that state dict;
  * :class:`ArcFaceEmbedder`, the pluggable embedder for
    ``eval/landmarks.face_metrics_frame``: optional 5-point alignment to
    the canonical ArcFace 112x112 template, then the IResNet forward in
    fp32.

Without a checkpoint the net is RANDOMLY INITIALIZED (loud warning): Deg
stays computable but is NOT paper-comparable.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# canonical ArcFace 112x112 5-point template (public insightface constant:
# eyes, nose tip, mouth corners)
ARC_TEMPLATE_112 = np.array([
    [38.2946, 51.6963],
    [73.5318, 51.5014],
    [56.0252, 71.7366],
    [41.5493, 92.3655],
    [70.7299, 92.2041],
], np.float64)

IRESNET50_LAYERS = (3, 4, 14, 3)
IRESNET18_LAYERS = (2, 2, 2, 2)


class BatchNorm(nn.Module):
    """BatchNorm on running statistics (eps 1e-5) over channel axis 1 of
    [N, C] or [N, C, H, W], with torch's parameter names and no
    `num_batches_tracked` buffer."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_extra(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


class IBasicBlock(nn.Module):
    """pre-BN residual block: bn-conv-bn-prelu-conv(stride)-bn (+1x1 skip)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(inplanes)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False), BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """ArcFace IResNet backbone: [N, 112, 112, 3] in [-1, 1] ->
    [N, num_features].  `layers`: blocks per stage (IRESNET50_LAYERS for
    iresnet50).  `fc` reads the NCHW (channel-major) flatten, as the public
    checkpoints were trained."""

    def __init__(self, layers=IRESNET50_LAYERS, num_features: int = 512):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(64)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for bi in range(n):
                blocks.append(IBasicBlock(inplanes, planes, stride=2 if bi == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.bn2 = BatchNorm(512)
        self.fc = nn.Linear(512 * 7 * 7, num_features)     # 112 / 2**4 = 7
        self.features = BatchNorm(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        x = self.bn2(x)
        return self.features(self.fc(torch.flatten(x, 1)))


def arcface_state_dict_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's IResNet variables (nested dicts of arrays under
    ``params`` and ``batch_stats``) -> the `arcface_torch` state dict that
    :class:`IResNet` loads: the inverse of that package's
    ``port_arcface_torch_weights``."""
    from pgtformer_tpu_torch.convert import flax_to_state_dict
    return {(k[:-len("alpha")] + "weight" if k.endswith(".alpha") else k): v
            for k, v in flax_to_state_dict(variables).items()}


class ArcFaceEmbedder:
    """Pluggable identity embedder for Deg (``eval/landmarks.py`` interface).

    `weights_path` (or `torch_state_dict`): the `arcface_torch` state dict of
    the matching iresnet; without one the net is RANDOM, drawn from a seeded
    generator (warns unless `warn_random` is off).  `detector`: optional
    5-point landmark detector; when given, faces are similarity-aligned to
    the ArcFace 112x112 template before embedding (standard ArcFace
    protocol); otherwise the (already face-centric VFHQ) frame is resized
    to 112.  The net runs in fp32 on `device` (`cuda` unless given).
    """

    def __init__(self, weights_path: Optional[str] = None,
                 detector: Optional[Callable] = None,
                 layers: tuple = IRESNET50_LAYERS,
                 torch_state_dict: Optional[Mapping] = None,
                 warn_random: bool = True, device=None):
        from pgtformer_tpu_torch import resolve_device
        from pgtformer_tpu_torch.convert import load_checkpoint, load_into
        from pgtformer_tpu_torch.nn.blocks import init_weights
        model = init_weights(IResNet(tuple(layers)), torch.Generator().manual_seed(2024))
        if weights_path:
            torch_state_dict = load_checkpoint(weights_path, param_key=None)
        if torch_state_dict is not None:
            load_into(model, torch_state_dict)
        elif warn_random:
            print("WARNING: ArcFace embedder running with RANDOM weights: 'deg' "
                  "is NOT paper-comparable. Drop in an insightface arcface_torch "
                  "backbone.pth via --arcface-weights.", file=sys.stderr)
        self.random_weights = torch_state_dict is None
        self.detector = detector
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _crop(self, img: np.ndarray) -> np.ndarray:
        import cv2
        if self.detector is not None:
            lm = np.asarray(self.detector(img), np.float64)
            m = cv2.estimateAffinePartial2D(lm, ARC_TEMPLATE_112,
                                            method=cv2.LMEDS)[0]
            if m is not None:
                return cv2.warpAffine(img, m, (112, 112),
                                      borderMode=cv2.BORDER_REPLICATE)
        return cv2.resize(img, (112, 112), interpolation=cv2.INTER_AREA)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img [H, W, 3] float in [0, 1] -> embedding [num_features]."""
        face = self._crop(np.asarray(img, np.float32))
        x = torch.as_tensor((face - 0.5) / 0.5, device=self.device)[None]
        with torch.no_grad():
            return self.model(x)[0].cpu().numpy()
