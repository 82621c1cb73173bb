"""Weight bridge: JAX-package variable trees and reference checkpoints.

``flax_to_state_dict`` turns the JAX package's variable tree (nested dicts
of numpy arrays under ``params``, ``batch_stats``, ``codebook``) into the
reference-format state_dict that the port's modules load with
``load_state_dict(strict=True)``.  It is an independent copy of that
package's flax-path -> torch-key rules, so no JAX is needed here.

Layout transforms: conv kernel HWIO -> OIHW, dense kernel (I, O) -> (O, I),
norm scale -> weight, BN mean/var -> running_mean/var, packed attention
in_proj_kernel (C, 3C) -> in_proj_weight (3C, C).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_MODULE_RENAMES = [
    (re.compile(r"^down_(\d+)_block_(\d+)$"), r"down.\1.block.\2"),
    (re.compile(r"^down_(\d+)_attn_(\d+)$"), r"down.\1.attn.\2"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down.\1.downsample"),
    (re.compile(r"^up_(\d+)_block_(\d+)$"), r"up.\1.block.\2"),
    (re.compile(r"^up_(\d+)_attn_(\d+)$"), r"up.\1.attn.\2"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up.\1.upsample"),
    (re.compile(r"^mid_block_(\d+)$"), r"mid.block_\1"),
    (re.compile(r"^mid_attn_(\d+)$"), r"mid.attn_\1"),
    (re.compile(r"^blocks_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^ft_layers_(\d+)$"), r"ft_layers.\1"),
    (re.compile(r"^blocks_(\d+)_conv$"), r"blocks.\1.conv"),
    (re.compile(r"^main_(\d+)$"), r"main.\1"),
    (re.compile(r"^fuse_convs_(\d+)$"), r"fuse_convs_dict.\1"),
    (re.compile(r"^layer(\d+)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^downsample_conv$"), r"downsample.0"),
    (re.compile(r"^downsample_bn$"), r"downsample.1"),
    (re.compile(r"^(scale|shift)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^idx_pred_norm$"), r"idx_pred_layer.0"),
    (re.compile(r"^idx_pred_head$"), r"idx_pred_layer.1"),
]

_LEAF_RENAMES = {
    "kernel": "weight",
    "scale": "weight",
    "embedding": "embedding.weight",
    "embed": "embed.weight",
    "bias": "bias",
    "in_proj_kernel": "in_proj_weight",
    "in_proj_bias": "in_proj_bias",
    "relative_position_bias_table": "relative_position_bias_table",
    "mean": "running_mean",
    "var": "running_var",
}

# buffers the reference recomputes from geometry or only uses in training
_DERIVED_BUFFERS = ("num_batches_tracked", "relative_position_index")


def _map_module_name(name: str, context: Tuple[str, ...]) -> str:
    # the self-attention of an encoder block is `attn` in the reference
    if name == "attn1" and "cross" not in context:
        return "attn"
    # the Fuse-SFT resblock names its 1x1 shortcut `conv_out`
    if name == "nin_shortcut" and "encode_enc" in context:
        return "conv_out"
    for pat, repl in _MODULE_RENAMES:
        if pat.match(name):
            return pat.sub(repl, name)
    return name


def flax_path_to_torch_key(col: str, path: Tuple[str, ...]) -> str:
    """Translate a flax variable path into the reference state_dict key."""
    *mods, leaf = path
    torch_mods = [_map_module_name(p, tuple(mods)) for p in mods]
    if col == "codebook":
        m = re.match(r"^codebooks_(\d+)_(weight|cluster_size_ema|embed_ema)$", leaf)
        if not m:
            raise KeyError(f"unrecognized codebook leaf {leaf!r}")
        return ".".join(torch_mods + [f"codebooks.{m.group(1)}", m.group(2)])
    return ".".join(torch_mods + [_LEAF_RENAMES.get(leaf, leaf)])


def _to_torch_leaf(leaf_name: str, value) -> np.ndarray:
    v = np.asarray(value)
    if leaf_name == "kernel":
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
    elif leaf_name == "in_proj_kernel":
        v = v.T
    return np.ascontiguousarray(v)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX-package variables (nested dicts of arrays) -> reference-format
    state_dict of numpy arrays."""
    return {flax_path_to_torch_key(col, path): _to_torch_leaf(path[-1], val)
            for col, tree in variables.items()
            for path, val in _flatten(tree)}


def load_checkpoint(path: str, param_key: str = "params_ema") -> Dict[str, torch.Tensor]:
    """Load a reference-format checkpoint: a .pth (BasicSR style, under
    `param_key` when present) or a flat .safetensors file."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if param_key and isinstance(obj, dict) and param_key in obj:
        obj = obj[param_key]
    return dict(obj)


def load_into(module: torch.nn.Module, state_dict: Mapping[str, Any]) -> torch.nn.Module:
    """`load_state_dict(strict=True)` of a reference-format dict (numpy or
    torch values), ignoring the derived buffers a reference checkpoint may
    carry (`num_batches_tracked`, `relative_position_index`)."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
          for k, v in state_dict.items()
          if not k.endswith(_DERIVED_BUFFERS)}
    module.load_state_dict(sd, strict=True)
    return module
