"""Documented evaluation-plan / numerics knobs (PyTorch port).

An independent copy of the JAX package's ``knobs.py`` registry: the same
names, defaults and choices.  Resolution order, highest priority first:

1. programmatic ``set_knob()`` (what the CLI flags call);
2. the ``PGT_<NAME>`` environment variable;
3. the built-in default.

* ``EXACT_VQ``: the fused nearest-code kernel drops the per-row ``|x|^2``
  term and sums in another order than ``argmin(compute_distances)``, so the
  two can break a near-tie differently.  ``1`` forces the exact argmin on
  every device.
* ``SW_KERNEL`` / ``SW_PAIR``: evaluation plans of the shifted-window
  blocks.  All plans compute the same function and are tested against each
  other.
* ``SUBPIXEL`` / ``FUSE_TPATH``: evaluation plans of the upsample's conv
  and of the Fuse-SFT block's frame mix.  Their plans round at different
  places in bf16 (each one where the JAX package's same plan does), so they
  agree to bf16 accuracy and exactly in fp32 up to summation order.
* ``SW_RPS``: the shifted-window kernels' slabs per CTA; every value that
  fits gives the same output bit for bit.
* ``FUSED_TAIL``: evaluation plan of the decoder's upsamples and per-frame
  tail (bf16 inference only).  The fused chain rounds to bf16 at other
  places than the stock modules, so its output agrees with theirs to bf16
  accuracy, not bit for bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Knob:
    name: str                       # PGT_<name> is the env fallback
    default: str
    choices: Optional[Tuple[str, ...]]
    help: str


KNOBS: Dict[str, Knob] = {k.name: k for k in [
    Knob("EXACT_VQ", "0", ("0", "1"),
         "'1' forces argmin over the full squared distances for the VQ code "
         "lookup on every device (the same codes on the CPU and the card). "
         "Default '0' uses the fused nearest-code kernel on a CUDA tensor, "
         "which can break near-ties differently"),
    Knob("SW_PAIR", "0", ("0", "1"),
         "'1' runs each [no-shift, shift] pair of shifted-window blocks as "
         "ONE kernel launch (block 0 for every window, a grid-wide barrier, "
         "then block 1). Same results as one launch per block (default '0'); "
         "applies to SW_KERNEL=5d"),
    Knob("SW_KERNEL", "5d", ("5d", "tokens"),
         "Shifted-window block kernel: '5d' reads windows straight from the "
         "[B,T,H,W,C] layout with the shift as an address change (default), "
         "'tokens' rolls and partitions in PyTorch and runs the kernel on "
         "the [M,N,C] window-token array with an explicit mask"),
    Knob("FUSED_TAIL", "0", ("0", "up", "1"),
         "Decoder tail under bf16 inference: 'up' runs every conv upsample "
         "whose input has H divisible by 8 and C by 128 as the fused subpixel "
         "kernel (four 2x2 phase convs, interleaved write); '1' runs the "
         "middle-frame tail (last upsample, both full-resolution resblocks, "
         "norm_out and SiLU) as a chain of fused GroupNorm+SiLU+conv3x3 "
         "kernels that pass GroupNorm statistics along. Default '0' keeps the "
         "stock modules; under fp32 the knob is ignored"),
    Knob("FUSE_TPATH", "conv", ("conv", "einsum"),
         "Fuse-SFT block's frame mix: 'conv' folds the 1x1 tconvenc/tconvdec "
         "convs into tfusion0's kernel in fp32 and runs one product over "
         "(frame, channel) per input (default); 'einsum' runs the two 1x1 "
         "convs, then two products over (frame, tcc channel). Same "
         "parameters"),
    Knob("SW_RPS", "", None,
         "Slabs of 48 window-token rows per CTA of the shifted-window "
         "kernels (sw_block and sw_block_tokens; sw_block_pair takes only "
         "1); an integer that fits shared memory at the layer's width. "
         "Empty = picked from the geometry (default). The output is the "
         "same for every value. The name is the JAX package's, the meaning "
         "is not (there: window rows per stripe): its values are not taken "
         "as they are, and 2, for one, is refused at width 512"),
    Knob("SUBPIXEL", "dilated", ("dilated", "quad"),
         "Upsample conv3x3(nearest_up2) plan: 'dilated' = one transposed "
         "conv (stride 2) with the 4x4 kernel summed from the 3x3 taps "
         "(default); 'quad' = four 2x2 phase convs on the source grid, "
         "interleaved. Same parameters"),
]}

_overrides: Dict[str, str] = {}


def _validate(knob: Knob, value: str) -> str:
    value = str(value)
    if knob.choices is not None and value not in knob.choices:
        raise ValueError(
            f"knob {knob.name}: invalid value {value!r} "
            f"(choices: {', '.join(knob.choices)})")
    return value


def get(name: str) -> str:
    knob = KNOBS[name]
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get("PGT_" + name)
    if env is not None:
        return _validate(knob, env)
    return knob.default


def set_knob(name: str, value) -> None:
    _overrides[name] = _validate(KNOBS[name], value)


def reset(name: Optional[str] = None) -> None:
    if name is None:
        _overrides.clear()
    else:
        _overrides.pop(name, None)


def _flag(name: str) -> str:
    return "--" + name.lower().replace("_", "-")


def add_cli_flags(parser) -> None:
    """Add one flag per knob to an argparse parser (default None = keep
    env/default resolution)."""
    g = parser.add_argument_group(
        "evaluation-plan/numerics knobs",
        "kernel-selection and determinism knobs; each also honors a "
        "PGT_<NAME> environment variable (flag wins). See README.")
    for knob in KNOBS.values():
        g.add_argument(_flag(knob.name), dest=f"knob_{knob.name}",
                       default=None, choices=knob.choices,
                       metavar=None if knob.choices else "VALUE",
                       help=knob.help.replace("%", "%%")
                       + f" [env: PGT_{knob.name}]")


def apply_cli_args(args) -> None:
    for name in KNOBS:
        v = getattr(args, f"knob_{name}", None)
        if v is not None:
            set_knob(name, v)
