"""Model registry: copy of bnv_fusion_tpu/models/registry.py."""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}


def register(name: str):
    def deco(cls):
        _MODELS[name] = cls
        return cls

    return deco


def get_model(name: str):
    if name not in _MODELS:
        raise KeyError(f"unknown model '{name}'; registered: {sorted(_MODELS)}")
    return _MODELS[name]
