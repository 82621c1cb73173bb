"""Typed configuration trees (PyTorch port).

The same frozen dataclasses and reference-YAML key names as the JAX
package's ``config.py``, kept as an independent copy so the port imports
nothing of that package.  ``yaml`` is imported only when an option file is
read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


def _tup(x) -> tuple:
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) for v in x)
    return x


@dataclass(frozen=True)
class DDConfig:
    """Encoder/decoder tower config (reference `ddconfig` subtree)."""
    double_z: bool = False
    z_channels: int = 256
    resolution: int = 512
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4, 8)
    depths: Tuple[int, ...] = (2, 2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8, 8)
    window_sizes: Tuple[Tuple[int, int], ...] = ((4, 4),) * 5
    num_frames: int = 3
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = (32, 64, 128)
    dropout: float = 0.0
    resamp_with_conv: bool = True
    stages_atten: int = 4
    window_size: Tuple[int, int, int] = (5, 5, 5)
    num_head: int = 8

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DDConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _tup(v) for k, v in d.items() if k in known})

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    def level_resolutions(self) -> Tuple[int, ...]:
        """Spatial resolution seen by each encoder level (before its downsample)."""
        return tuple(self.resolution // (2 ** i) for i in range(self.num_resolutions))

    @property
    def first_attn_level(self) -> int:
        """Index of the first encoder level with window attention; the
        levels before it are per-frame convs (the cacheable trunk)."""
        for i, res in enumerate(self.level_resolutions()):
            if res in self.attn_resolutions:
                return i
        return self.num_resolutions


@dataclass(frozen=True)
class VQVAEConfig:
    """TDCRQVAE3 config (reference constructor kwargs)."""
    ddconfig: DDConfig = field(default_factory=DDConfig)
    embed_dim: int = 512
    n_embed: int = 1024
    decay: float = 0.99
    loss_type: str = "mse"
    latent_loss_weight: float = 0.25
    bottleneck_type: str = "rq"
    latent_shape: Tuple[int, int, int] = (32, 32, 512)
    code_shape: Tuple[int, int, int] = (32, 32, 1)
    shared_codebook: bool = True
    restart_unused_codes: bool = True
    checkpointing: bool = False
    tf: int = 3

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VQVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: _tup(v) for k, v in d.items() if k in known and k != "ddconfig"}
        if "ddconfig" in d:
            kw["ddconfig"] = DDConfig.from_dict(d["ddconfig"])
        return cls(**kw)


@dataclass(frozen=True)
class PGTFormerConfig:
    """Flagship model config (reference PGTFormer constructor kwargs)."""
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    dim_embd: int = 512
    n_head: int = 8
    n_layers: int = 9
    connect_list: Tuple[str, ...] = ("32", "64", "128", "256")
    fix_modules: Tuple[str, ...] = ("quantizer", "decoder", "conditionnet")
    w: float = 0.0
    detach_16: bool = True
    adain: bool = False
    droprate: float = 0.0
    n_parsing_classes: int = 19

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PGTFormerConfig":
        known = {f.name for f in dataclasses.fields(cls)} - {"vqvae"}
        kw = {k: _tup(v) for k, v in d.items() if k in known}
        kw["vqvae"] = VQVAEConfig.from_dict(d)
        return cls(**kw)


def load_options(path: str) -> dict:
    """Load a reference-style option YAML into a plain nested dict."""
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def pgtformer_config_from_options(opt: Mapping[str, Any],
                                  network_key: str = "network_g") -> PGTFormerConfig:
    net = dict(opt[network_key])
    net.pop("type", None)
    return PGTFormerConfig.from_dict(net)


def vqvae_config_from_options(opt: Mapping[str, Any],
                              network_key: str = "network_gt") -> VQVAEConfig:
    """The `TDCRQVAE3` config of an option tree: stage I's `network_g`, or
    a later stage's frozen teacher `network_gt`."""
    net = dict(opt[network_key])
    net.pop("type", None)
    return VQVAEConfig.from_dict(net)


# The deployed release config (options/release_test_stage_IIII_dont_need_
# align_version.yml): 512x512, T=3, ch 64, ch_mult (1,2,4,4,8), 4x4 windows,
# attention at {32,64,128}, 9 code-transformer layers of width 512,
# codebook 1024x512, w=1, AdaIN on.
RELEASE_PGTFORMER = PGTFormerConfig(
    vqvae=VQVAEConfig(),
    w=1.0,
    adain=True,
)
