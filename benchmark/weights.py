"""Seeded weights in the reference checkpoint's format.

One draw of standard normals for the whole model, made on the device from
the seed, is shaped into every entry of the reference model's state dict:

* a conv or linear weight (2-D or more): N(0, 1) / sqrt(fan-in), so that
  activations keep their scale through the depth of the model;
* a norm's weight: 1 + 0.1 N(0, 1); every bias, and a norm's bias:
  0.1 N(0, 1), never zero;
* batch-norm statistics: mean 0.1 N(0, 1), variance 1 + 0.25 tanh(N(0, 1));
* a relative-position bias table: 0.02 N(0, 1); a codebook: N(0, 1), with
  the padding row of a residual codebook (its last) zero;
* any other entry: 0.1 N(0, 1).

A configuration's ``weights`` entry then scales (``gain``) or shifts
(``offset``) every entry whose key contains one of its patterns: the last
conv of each Fuse-SFT head, for one, so that no block starts as the
identity and none dominates, and the output conv, so that frames fall
inside the clamped range.  Values are rounded once to the served dtype and
handed over as one host buffer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch


def _rule(key: str, shape: Tuple[int, ...]):
    """(scale, offset, kind) of one entry before the configuration's rules."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "relative_position_bias_table":
        return 0.02, 0.0, "plain"
    if leaf == "running_mean":
        return 0.1, 0.0, "plain"
    if leaf == "running_var":
        return 0.25, 1.0, "tanh"
    if leaf == "weight" and ("codebooks" in key or key.endswith("embedding.weight")):
        return 1.0, 0.0, "codebook"
    if leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return fan_in ** -0.5, 0.0, "plain"
    if leaf == "weight" and len(shape) == 1:
        return 0.1, 1.0, "plain"
    return 0.1, 0.0, "plain"


def make_state_dict(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                    rules: Mapping = None, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """{key: host tensor} for every (key, shape), drawn from `seed` on
    `device` and rounded to `dtype`; `rules` is a configuration's
    ``weights`` entry ({"gain": {pattern: g}, "offset": {pattern: b}})."""
    rules = rules or {}
    gains, offsets = rules.get("gain", {}), rules.get("offset", {})
    sizes = []
    for _, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        sizes.append(n)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out_flat = torch.empty(sum(sizes), device=device, dtype=dtype)
    views = {}
    at = 0
    with torch.no_grad():
        for (key, shape), n in zip(shapes, sizes):
            x = flat[at:at + n]
            scale, offset, kind = _rule(key, tuple(shape))
            if kind == "tanh":
                x = torch.tanh(x)
            x = x * scale + offset
            if kind == "codebook" and "codebooks" in key:
                x = x.reshape(shape)
                x[-1] = 0.0                 # the residual codebook's padding row
                x = x.reshape(-1)
            for pat, gain in gains.items():
                if pat in key:
                    x = x * gain
            for pat, b in offsets.items():
                if pat in key:
                    x = x + b
            out_flat[at:at + n] = x.to(dtype)
            views[key] = (at, n, tuple(shape))
            at += n
    host = out_flat.cpu()
    del flat, out_flat
    return {k: host[a:a + n].view(shape) for k, (a, n, shape) in views.items()}
