"""Seeded random weights of the reference's networks, made on the device.

The PointNet encoder (6 -> hidden x layers -> latent) and the SDF decoder
(PE(3) + latent -> hidden x layers -> 1) at the widths a configuration
names, He-normal weights and normal biases of ``bias_std`` (untrained
biases are not zero), drawn from one ``torch.Generator`` on the run's
device in two calls; the decoder's output layer is scaled by the
configuration's ``decoder_out_gain``.  Both the system and the plain
reference are handed this same tree of float32 numpy arrays
({"encoder", "decoder"} of ``w0, b0, ..., w_out, b_out``, ``w`` stored
[in, out]).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.rooflines import layer_dims
from benchmark.traffic.generator import sub_seeds


def make_params(net: Dict, seed: int,
                device) -> Dict[str, Dict[str, np.ndarray]]:
    dims = layer_dims(net)
    n_w = sum(a * b for d in dims.values() for a, b in zip(d[:-1], d[1:]))
    n_b = sum(b for d in dims.values() for b in d[1:])
    g = torch.Generator(device=device).manual_seed(sub_seeds(seed, 2)[1])
    w_all = torch.randn(n_w, generator=g, device=device).cpu().numpy()
    b_all = (torch.randn(n_b, generator=g, device=device) *
             float(net["bias_std"])).cpu().numpy()
    tree, iw, ib = {}, 0, 0
    for name, d in dims.items():
        layers = {}
        n = len(d) - 1
        for i in range(n):
            wk, bk = (f"w{i}", f"b{i}") if i < n - 1 else ("w_out", "b_out")
            k = d[i] * d[i + 1]
            layers[wk] = (w_all[iw:iw + k].reshape(d[i], d[i + 1]) *
                          np.float32(np.sqrt(2.0 / d[i]))).astype(np.float32)
            layers[bk] = b_all[ib:ib + d[i + 1]].astype(np.float32)
            iw += k
            ib += d[i + 1]
        if name == "decoder":
            gain = np.float32(net.get("decoder_out_gain", 1.0))
            layers["w_out"] = layers["w_out"] * gain
            layers["b_out"] = layers["b_out"] * gain
        tree[name] = layers
    return tree
