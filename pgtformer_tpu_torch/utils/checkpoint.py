"""Checkpoint / resume on ``torch.save`` (the port's counterpart of the JAX
package's orbax ``utils/checkpoint.py``).

BasicSR's conventions, which the reference relies on: a periodic training
state for ``auto_resume``, and ``net_g_<iter>`` exports of the EMA weights
under ``params_ema``:

    <dir>/
      state/<step>.pth      # the whole training state (below)
      latest                # text file with the newest step
      net_g_<step>.pth      # {"params_ema": generator state_dict}
      net_d_<step>.pth      # {"params_ema": discriminator state_dict}

A training state file holds the step; the generator's ``state_dict()``
(parameters, codebooks, BatchNorm statistics); its parameters' EMA; the
generator's Adam and LR schedule; the discriminator's ``state_dict()``, Adam
and schedule; the state's random generator; and the loader's position
(``PrefetchLoader.position_at``: epoch, batches of it consumed, and the
epochs' cut), from which a resumed run starts the loader.  Each file is written under a temporary
name and moved into place with ``os.replace``, and ``latest`` is written
last, so a run killed mid-save resumes from the previous state.

:meth:`CheckpointManager.restore` loads INTO the trainer's live modules,
optimizers and schedulers (``load_state_dict``, ``copy_``): the state's
tensor dicts and the optimizers' param groups keep pointing at the tensors
the step updates.

Exports are reference-format state dicts (the parameters replaced by their
EMA, codebook and BatchNorm buffers as they stand), so ``convert.
load_checkpoint`` reads them and ``cli.py --weights`` and ``train_cli.py
--teacher-ckpt/--student-ckpt/--disc-ckpt`` take them unchanged.  The JAX
package's orbax export directories cannot be read here (no orbax); convert
their variables with ``convert.flax_to_state_dict`` and ``torch.save``
``{"params_ema": ...}`` instead.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

STATE_FORMAT = "pgtformer_tpu_torch.train_state.v1"


def _atomic_save(obj: Any, path: str) -> int:
    """torch.save to a temporary name, then os.replace; returns the bytes."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def generator_export(stage_trainer, state) -> Dict[str, torch.Tensor]:
    """The generator's reference-format state_dict with every parameter
    replaced by its EMA (codebooks and BatchNorm statistics as they stand):
    what ``net_g_<step>.pth`` holds under ``params_ema``."""
    sd = dict(stage_trainer.model.state_dict())
    sd.update(state.g.ema_params)
    return _cpu(sd)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def state_path(self, step: int) -> str:
        return os.path.join(self.directory, "state", f"{step}.pth")

    def save(self, step: int, state, stage_trainer,
             loader_position: Optional[Dict[str, int]] = None) -> Tuple[str, int]:
        """Write the training state of `step`; returns (path, bytes)."""
        tr = stage_trainer
        d = getattr(tr, "disc", None) if state.d is not None else None
        payload = {
            "format": STATE_FORMAT,
            "step": int(step),
            "g": _cpu(tr.model.state_dict()),
            "ema": _cpu(state.g.ema_params),
            "opt_g": tr.opt_g.state_dict(),
            "sched_g": tr.sched_g.state_dict(),
            "d": _cpu(d.state_dict()) if d is not None else None,
            "opt_d": tr.opt_d.state_dict() if d is not None else None,
            "sched_d": tr.sched_d.state_dict() if d is not None else None,
            "rng": state.rng.get_state(),
            "loader": dict(loader_position) if loader_position is not None else None,
        }
        path = self.state_path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        nbytes = _atomic_save(payload, path)
        tmp = os.path.join(self.directory, f"latest.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.directory, "latest"))
        self._gc()
        return path, nbytes

    def _gc(self):
        root = os.path.join(self.directory, "state")
        if not os.path.isdir(root):
            return
        steps = sorted(int(m.group(1)) for m in
                       (re.fullmatch(r"(\d+)\.pth", n) for n in os.listdir(root)) if m)
        for s in steps[:-self.max_to_keep]:
            os.remove(self.state_path(s))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def read_state(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The payload of a training state file (tensors on the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        payload = torch.load(self.state_path(step), map_location="cpu", weights_only=True)
        if payload.get("format") != STATE_FORMAT:
            raise ValueError(f"{self.state_path(step)}: not a {STATE_FORMAT} file")
        return payload

    def restore(self, state, stage_trainer, step: Optional[int] = None):
        """Load the state of `step` (default: the latest) into `state` and
        the trainer's live modules, optimizers and schedulers, in place.
        Returns (state, step), or (None, None) when there is nothing to
        restore.  The payload's loader position is left in
        ``self.restored_loader_position``."""
        payload = self.read_state(step)
        if payload is None:
            return None, None
        tr = stage_trainer
        tr.model.load_state_dict(payload["g"], strict=True)
        ema = payload["ema"]
        if ema.keys() != state.g.ema_params.keys():
            raise ValueError("checkpoint EMA keys differ from the trainer's parameters")
        with torch.no_grad():
            for k, t in state.g.ema_params.items():
                t.copy_(ema[k])
        tr.opt_g.load_state_dict(payload["opt_g"])
        tr.sched_g.load_state_dict(payload["sched_g"])
        if (payload["d"] is None) != (state.d is None):
            raise ValueError("checkpoint and trainer disagree on having a discriminator")
        if state.d is not None:
            tr.disc.load_state_dict(payload["d"], strict=True)
            tr.opt_d.load_state_dict(payload["opt_d"])
            tr.sched_d.load_state_dict(payload["sched_d"])
            state.d.opt_state = tr.opt_d.state_dict()
        state.g.opt_state = tr.opt_g.state_dict()
        state.rng.set_state(payload["rng"])
        state.step = int(payload["step"])
        self.restored_loader_position = payload["loader"]
        return state, state.step

    def export_params_ema(self, step: int, state_dict: Mapping[str, torch.Tensor],
                          prefix: str = "net_g") -> Tuple[str, int]:
        """Inference checkpoint ``<prefix>_<step>.pth``: ``{"params_ema":
        state_dict}``; returns (path, bytes)."""
        path = os.path.join(self.directory, f"{prefix}_{step}.pth")
        return path, _atomic_save({"params_ema": _cpu(state_dict)}, path)


def read_export(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format state dict from a ``net_{g,d}_<step>.pth`` export
    or any reference checkpoint (``convert.load_checkpoint``).  Refuses the
    JAX package's orbax export directories, which need orbax."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (a JAX-package orbax export?): the port reads "
            "reference-format .pth/.safetensors files only.  Convert the JAX "
            "variables with pgtformer_tpu_torch.convert.flax_to_state_dict and "
            "torch.save({'params_ema': state_dict}, 'net_g.pth').")
    from pgtformer_tpu_torch.convert import load_checkpoint
    return load_checkpoint(path)


def merge_pretrained(state_dict: Mapping[str, torch.Tensor],
                     pretrained: Mapping[str, Any]):
    """Non-strict pretrained load, BasicSR's ``strict_load_g: false`` (the
    stage chain I -> II -> III -> IV partially initializes each student from
    the previous stage's export).

    `state_dict`: a freshly initialized model's state_dict (reference keys).
    `pretrained`: an export (``{"params_ema": sd}``) or a plain state_dict.
    Copies every tensor whose key exists in both with the same shape (cast
    to the destination's dtype); returns ``(merged, n_loaded, skipped)``,
    `skipped` being the pretrained keys without such a destination."""
    src = pretrained.get("params_ema", pretrained) if isinstance(pretrained, Mapping) else pretrained
    merged = dict(state_dict)
    n_loaded = 0
    skipped: List[str] = []
    for k, v in src.items():
        v = torch.as_tensor(v)
        if k in merged and tuple(merged[k].shape) == tuple(v.shape):
            merged[k] = v.to(merged[k].dtype)
            n_loaded += 1
        else:
            skipped.append(k)
    return merged, n_loaded, skipped
