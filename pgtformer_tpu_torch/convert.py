"""Weight bridge: JAX-package variable trees and reference checkpoints.

``flax_to_state_dict`` turns the JAX package's variable tree (nested dicts
of numpy arrays under ``params``, ``batch_stats``, ``codebook``) into the
reference-format state_dict that the port's modules load with
``load_state_dict(strict=True)``.  It is an independent copy of that
package's flax-path -> torch-key rules, so no JAX is needed here.

Layout transforms: conv kernel HWIO -> OIHW, dense kernel (I, O) -> (O, I),
norm scale -> weight, BN mean/var -> running_mean/var, packed attention
in_proj_kernel (C, 3C) -> in_proj_weight (3C, C).

The same rules carry the training networks' variables across: the PatchGAN
discriminator's ``params`` and ``batch_stats`` (``main_{i}`` ->
``main.{i}``, into ``models/vqgan.py:VQGANDiscriminator``) and LPIPS's
(``vgg/conv_{i}``, ``lin_{i}``, into ``train/lpips.py:LPIPS``).

The checkpoint surface of the JAX package's ``convert/torch_port.py``:
:func:`load_checkpoint`, :func:`save_reference_checkpoint`,
:func:`port_subtree`, :func:`from_pretrained` and :func:`push_to_hub`'s
staging.  ``.safetensors`` files are read and written here
(:func:`load_safetensors`, :func:`save_safetensors`: an 8-byte
little-endian header length, a JSON header of ``dtype``/``shape``/
``data_offsets``, then the raw buffers), so no package beyond torch is
needed.  Two divergences: :func:`from_pretrained` takes a local file or
directory only (JAX downloads a hub id with ``huggingface_hub``; the port
never reaches the network), and :func:`push_to_hub` imports
``huggingface_hub`` only for the upload, as JAX does.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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


# -- .safetensors, read and written without the package ------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU (``__metadata__`` is
    skipped)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(data)} bytes)")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ValueError(f"{path}: header of {n} bytes past the end of the file")
    header = json.loads(data[8:8 + n])
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}")
        dt = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        shape = [int(d) for d in meta["shape"]]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dt).element_size() or 8 + n + end > len(data):
            raise ValueError(f"{path}: tensor {name!r} {meta['dtype']} {shape} "
                             f"does not fit its offsets {begin}..{end}")
        raw = bytearray(data[8 + n + begin:8 + n + end])
        t = torch.frombuffer(raw, dtype=dt) if count else torch.empty(0, dtype=dt)
        out[name] = t.reshape(shape)
    return out


def save_safetensors(tensors: Mapping[str, Any], path: str) -> None:
    """Write a flat mapping of tensors (torch or numpy) as a .safetensors
    file: buffers in name order, the header padded to 8 bytes."""
    header, chunks, off = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        if t.dtype not in _ST_CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def load_checkpoint(path: str, param_key: str = "params_ema") -> Dict[str, torch.Tensor]:
    """Load a reference-format checkpoint: a .pth (BasicSR style, under
    `param_key` when present) or a flat .safetensors file."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
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


def _reference_state_dict(module_or_state_dict) -> Dict[str, torch.Tensor]:
    """A module's state dict, or a reference-format dict (numpy or torch
    values), as CPU tensors without the derived buffers."""
    sd = (module_or_state_dict.state_dict() if isinstance(module_or_state_dict, torch.nn.Module)
          else module_or_state_dict)
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
            else v.detach().cpu()
            for k, v in sd.items() if not k.endswith(_DERIVED_BUFFERS)}


def save_reference_checkpoint(module_or_state_dict, path: str,
                              param_key: Optional[str] = "params_ema") -> None:
    """Write a module's weights (or a reference-format state dict) as a
    checkpoint the reference loads: a BasicSR-style .pth (``{param_key:
    state_dict}``, the bare dict when `param_key` is None) or a flat
    .safetensors file.  Derived buffers are not written."""
    sd = _reference_state_dict(module_or_state_dict)
    if path.endswith(".safetensors"):
        save_safetensors(sd, path)
        return
    torch.save({param_key: sd} if param_key else sd, path)


def port_subtree(module: torch.nn.Module, subtree: str, state_dict: Mapping[str, Any],
                 strict: bool = True) -> torch.nn.Module:
    """Load a standalone state dict into one submodule, e.g. a face-parsing
    BiSeNet checkpoint (the reference's commented-out
    ``weights/facelib/faceparse/79999.pth``) into ``conditionnet``:

        port_subtree(model, "conditionnet", bisenet_sd)

    `strict`: every key of the submodule, and no other, as in
    :func:`load_into`; without it the keys the submodule has are loaded
    and the rest are ignored.  Returns `module`."""
    sub = module.get_submodule(subtree)
    if strict:
        load_into(sub, state_dict)
    else:
        own = sub.state_dict()
        sub.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()
                             if k in own}, strict=False)
    return module


HUB_FILES = ("model.safetensors", "pytorch_model.bin")


def local_checkpoint(path: str) -> str:
    """`path` itself for a file; for a directory its ``model.safetensors``
    or ``pytorch_model.bin`` (in that order, as :func:`from_pretrained`
    looks for them).  Anything else raises: a hub repo id would need the
    network, which the port never reaches."""
    if os.path.isdir(path):
        for name in HUB_FILES:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"{path} holds neither {' nor '.join(HUB_FILES)}")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no such file or directory.  A hub repo id is not downloaded "
            f"(no network access); fetch its {HUB_FILES[0]} or {HUB_FILES[1]} and pass "
            "the file or its directory")
    return path


def from_pretrained(path: str, cfg=None, dtype: torch.dtype = torch.bfloat16, device=None,
                    param_key: Optional[str] = "params_ema"):
    """A PGTFormer filled from a reference-format checkpoint: a local
    .pth/.safetensors file, or a directory holding ``model.safetensors`` /
    ``pytorch_model.bin`` (:func:`local_checkpoint`).  `cfg` defaults to
    ``RELEASE_PGTFORMER`` and `dtype` to bf16, as in JAX; the model is
    returned in eval mode on `device` (the card unless the caller asks for
    another), on the kernels where that is CUDA (as ``VideoRestorer``).
    JAX also takes a hub repo id and downloads it; the port raises there
    (:func:`local_checkpoint`)."""
    from pgtformer_tpu_torch import default_use_pallas, resolve_device
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    device = resolve_device(device)
    sd = load_checkpoint(local_checkpoint(path), param_key=param_key)
    model = load_into(PGTFormer(cfg or RELEASE_PGTFORMER, use_pallas=default_use_pallas(device)),
                      sd)
    return model.to(device=device, dtype=dtype).eval()


def push_to_hub(module_or_state_dict, repo_id: str, staging_dir: Optional[str] = None,
                cfg=None, dry_run: bool = False, private: bool = True) -> str:
    """Publish weights as a reference-consumable hub model repo (the
    reference's PyTorchModelHubMixin ``push_to_hub``): stages
    ``pytorch_model.bin`` (the flat state dict its ``from_pretrained``
    loads) and a minimal ``config.json`` into `staging_dir`, then uploads
    the folder with ``huggingface_hub`` (imported only then).  With
    ``dry_run`` it stops after staging.  Returns the staged directory."""
    import tempfile
    staging_dir = staging_dir or tempfile.mkdtemp(prefix="pgt_hub_")
    os.makedirs(staging_dir, exist_ok=True)
    torch.save(_reference_state_dict(module_or_state_dict),
               os.path.join(staging_dir, "pytorch_model.bin"))
    meta = {"model_type": "PGTFormer", "framework": "pgtformer_tpu_torch"}
    if cfg is not None:
        meta["network_g"] = repr(cfg)
    with open(os.path.join(staging_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if dry_run:
        return staging_dir
    from huggingface_hub import HfApi
    api = HfApi()
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=staging_dir, repo_id=repo_id)
    return staging_dir
