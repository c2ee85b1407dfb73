"""Dataset registry: copy of bnv_fusion_tpu/datasets/registry.py."""

from __future__ import annotations

from typing import Callable, Dict

_DATASETS: Dict[str, Callable] = {}


def register(name: str):
    def deco(cls):
        _DATASETS[name] = cls
        return cls

    return deco


def get_dataset(cfg, stage: str):
    name = cfg.dataset.name
    if name not in _DATASETS:
        raise KeyError(
            f"unknown dataset '{name}'; registered: {sorted(_DATASETS)}")
    return _DATASETS[name](cfg, stage)


def get_dataset_cls(name: str) -> Callable:
    if name not in _DATASETS:
        raise KeyError(
            f"unknown dataset '{name}'; registered: {sorted(_DATASETS)}")
    return _DATASETS[name]


def registered() -> Dict[str, Callable]:
    return dict(_DATASETS)
