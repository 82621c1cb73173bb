"""pgtformer_tpu_torch — PGTFormer video face restoration in PyTorch/CUDA.

The PyTorch port of ``pgtformer_tpu``.  It imports nothing of that
package (nor JAX); plain tensor code is PyTorch and the two kernels of the
serving step are hand-written CUDA for Hopper (``csrc/``), built at first
use into ``build/kernels/``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another.  Without a card and without an explicit device this raises;
    nothing carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
