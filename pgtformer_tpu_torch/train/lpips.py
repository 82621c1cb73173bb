"""LPIPS perceptual distance (VGG16 trunk + non-negative linear heads).

Counterpart of the JAX package's ``train/lpips.py`` (the architecture of the
``lpips`` package's ``LPIPS(net='vgg')``): input in [0,1] -> [-1,1] ->
per-channel scaling -> VGG16 features at relu{1_2, 2_2, 3_3, 4_3, 5_3} ->
unit-normalize over channels (+1e-10) -> squared difference -> 1x1 head
with |weights| -> spatial mean -> sum over the five taps.

Parameter names follow the JAX variables through ``convert.py``
(``vgg.conv_{i}.weight``, ``lin_{i}``), so a JAX LPIPS variable tree loads
with ``load_state_dict(strict=True)``.  Real weights come from a local
``lpips.LPIPS(net='vgg')`` state_dict (:func:`port_lpips_torch_weights`);
without one the VGG is the port's own seeded random init, which keeps the
training recipe runnable but is not metric-grade, and
:func:`make_lpips_fn` says so loudly.  It computes in fp32, as the JAX
trainers' LPIPS does under bf16 training.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import conv_nhwc, init_weights

# VGG16 conv plan (out channels, or "M" for a 2x2 max-pool)
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512)
_TAP_AFTER_CONV = (2, 4, 7, 10, 13)        # convs counted from 1: relu1_2 ... relu5_3
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# the lpips package's ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 trunk on [N, H, W, 3] emitting the five LPIPS tap activations."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for item in _VGG16_PLAN:
            if item != "M":
                self.add_module(f"conv_{i}", nn.Conv2d(cin, item, 3, padding=1))
                cin, i = item, i + 1

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        i = 0
        for item in _VGG16_PLAN:
            if item == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            else:
                x = F.relu(conv_nhwc(getattr(self, f"conv_{i}"), x))
                i += 1
                if i in _TAP_AFTER_CONV:
                    taps.append(x)
        return tuple(taps)


class LPIPS(nn.Module):
    """forward(x, y): [N, H, W, 3] in [0, 1] -> per-sample distance [N]."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(_TAP_CHANNELS):
            self.register_parameter(f"lin_{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        prep = lambda im: (2.0 * im - 1.0 - self.shift) / self.scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(prep(x)), self.vgg(prep(y)))):
            a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin_{i}").abs()
            total = total + ((a - b) ** 2 * w).sum(-1).mean(dim=(1, 2))
        return total


def port_lpips_torch_weights(model: LPIPS, sd: Dict[str, torch.Tensor]) -> LPIPS:
    """Load an ``lpips.LPIPS(net='vgg')`` state_dict into `model` (in place;
    returned): the VGG convs ``net.slice{k}.{idx}.weight/bias`` in (slice,
    index) order become ``vgg.conv_{i}``, the heads ``lin{i}.model.1.weight``
    [1, C, 1, 1] become ``lin_{i}``.  Every conv must be present; a missing
    head keeps its value."""
    convs = sorted((k[:-len(".weight")] for k in sd if k.endswith(".weight") and ".slice" in k),
                   key=lambda s: (int(s.split("slice")[1].split(".")[0]), int(s.split(".")[-1])))
    n_convs = sum(1 for item in _VGG16_PLAN if item != "M")
    if len(convs) != n_convs:
        raise KeyError(f"lpips state_dict: {len(convs)} VGG convs, expected {n_convs}")
    with torch.no_grad():
        for i, base in enumerate(convs):
            conv = getattr(model.vgg, f"conv_{i}")
            conv.weight.copy_(torch.as_tensor(sd[base + ".weight"]))
            conv.bias.copy_(torch.as_tensor(sd[base + ".bias"]))
        for i in range(len(_TAP_CHANNELS)):
            key = f"lin{i}.model.1.weight"
            if key in sd:
                getattr(model, f"lin_{i}").copy_(torch.as_tensor(sd[key]).reshape(-1))
    return model


def make_lpips_fn(torch_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  weights_path: Optional[str] = None, device=None, seed: int = 1234,
                  warn_random: bool = True):
    """lpips_fn(x, y) -> per-sample distances [N] for [N, H, W, 3] frames in
    [0, 1], computed in fp32 with autocast off, on frozen weights.

    `torch_state_dict` (or the file `weights_path`) is an
    ``lpips.LPIPS(net='vgg')`` state_dict.  Without either the VGG is
    RANDOMLY INITIALIZED from `seed` (fan-in normal convs, unit heads): a
    training prior, not metric-grade, and a warning says so unless
    `warn_random` is off."""
    from pgtformer_tpu_torch import resolve_device
    from pgtformer_tpu_torch.convert import load_checkpoint
    if weights_path:
        torch_state_dict = load_checkpoint(weights_path, param_key=None)
    model = init_weights(LPIPS(), torch.Generator().manual_seed(seed))
    if torch_state_dict is not None:
        port_lpips_torch_weights(model, torch_state_dict)
    elif warn_random:
        print("WARNING: LPIPS running with RANDOM VGG weights: the training "
              "perceptual loss is a random-feature prior and LPIPS numbers are NOT "
              "comparable to published values. Pass an lpips.LPIPS(net='vgg') "
              "state_dict (torch_state_dict= or weights_path=) for metric-grade LPIPS.",
              file=sys.stderr)
    model = model.to(resolve_device(device)).eval().requires_grad_(False)

    def lpips_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return model(x.float(), y.float())

    lpips_fn.module = model
    lpips_fn.random_weights = torch_state_dict is None
    return lpips_fn
