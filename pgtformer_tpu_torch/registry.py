"""Registries for architectures / datasets / losses / model-trainers (the
port's copy of the JAX package's ``registry.py``).

Mirrors the registration surface the reference consumes from BasicSR
(``ARCH_REGISTRY`` / ``DATASET_REGISTRY``), so configs can name components
by string: the VFHQ datasets register under the reference's type names
(``VFHQFULLntmeBASICV2TRAINUP`` ...).

``ARCH_REGISTRY`` holds the seven architectures of the JAX package's, under
its names (``TDCRQVAE3``, ``PGTFormer``, ``RQVAE``, ``TDRQVAE``,
``CodeFormer``, ``VQAutoEncoder``, ``VQGANDiscriminator``): each model
module registers its class, and the registry imports those modules at its
first lookup, so ``ARCH_REGISTRY.get(name)(...)`` builds any of them
without an import of its own.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple


class Registry:
    """A name -> object map.  `modules` are imported at the first lookup
    (their imports register their objects)."""

    def __init__(self, name: str, modules: Tuple[str, ...] = ()):
        self._name = name
        self._obj_map: Dict[str, Any] = {}
        self._modules = modules

    def _load(self) -> None:
        modules, self._modules = self._modules, ()
        for m in modules:
            importlib.import_module(m)

    def register(self, obj: Any = None, *, name: str | None = None):
        if obj is None:  # used as decorator with kwargs
            def deco(inner):
                return self.register(inner, name=name)
            return deco
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"{key} already registered in {self._name}")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        self._load()
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}. "
                f"Available: {sorted(self._obj_map)}")
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        self._load()
        return name in self._obj_map

    def keys(self):
        self._load()
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch", tuple(f"pgtformer_tpu_torch.models.{m}" for m in (
    "vae", "pgtformer", "vqgan", "rqvae", "tdrqvae", "codeformer")))
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
MODEL_REGISTRY = Registry("model")  # trainer/model-wrapper classes (stage recipes)
