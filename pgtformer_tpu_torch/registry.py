"""Registries for architectures / datasets / losses / model-trainers (the
port's copy of the JAX package's ``registry.py``).

Mirrors the registration surface the reference consumes from BasicSR
(``ARCH_REGISTRY`` / ``DATASET_REGISTRY``), so configs can name components
by string: the VFHQ datasets register under the reference's type names
(``VFHQFULLntmeBASICV2TRAINUP`` ...).
"""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

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
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}. "
                f"Available: {sorted(self._obj_map)}")
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
MODEL_REGISTRY = Registry("model")  # trainer/model-wrapper classes (stage recipes)
