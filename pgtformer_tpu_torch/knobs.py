"""Documented evaluation-plan / numerics knobs (PyTorch port).

An independent copy of the JAX package's ``knobs.py`` registry, holding only
the knobs whose code this package has.  Resolution order, highest priority
first:

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
