"""pgtformer_tpu_torch — PGTFormer video face restoration in PyTorch/CUDA.

The PyTorch port of ``pgtformer_tpu``.  It imports nothing of that
package (nor JAX); plain tensor code is PyTorch and every kernel that
package wrote for the TPU is hand-written CUDA for Hopper here (``csrc/``,
wrappers in ``ops/``), built at first use into ``build/kernels/``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another.  Without a card this raises for `cuda`, asked for or by
    default; nothing carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return device


def default_use_pallas(device) -> bool:
    """The plan of serving and evaluation, as JAX's (``use_pallas`` on every
    backend but the CPU): the hand-written kernels where `device` is CUDA,
    the module path elsewhere.  Training takes the kernels only when asked."""
    return torch.device(device).type == "cuda"
