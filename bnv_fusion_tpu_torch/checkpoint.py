"""Save/load of framework state as a flat npz of a nested dict of arrays.

Counterpart of bnv_fusion_tpu/checkpoint.py:226-249 in the same file format
(keys are "/"-joined paths), so the two packages read each other's files.
The reader for the reference's .ckpt files is ROADMAP Queue 1 item 1.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def save_state(path: str, tree: Dict[str, Any]) -> None:
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", tree)
    np.savez_compressed(path, **flat)


def load_state(path: str) -> Dict[str, Any]:
    data = np.load(path, allow_pickle=False)
    tree: Dict[str, Any] = {}
    for key in data.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree
