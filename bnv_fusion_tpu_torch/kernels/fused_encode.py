"""PointNet encode of the K-frame fuse front: CUDA kernel + plain version.

Replaces no TPU kernel: the JAX package leaves this encoder to XLA
(bnv_fusion_tpu/fusion.py ``_encode_sorted_fm``, vmapped over the K
frames).  ``fused_encode_sorted`` takes the fuse front's stage-1 sorted
points of K frames (voxel coordinates and normals [K, N, 3], validity
[K, N]) and returns the encoder's features FEATURE-MAJOR, [K, 8F, N] with
channel f * 8 + p (feature-major, corner-minor: the layout
``seg_reduce_sorted`` reads), zero for invalid points.  On CUDA tensors it
launches the hand-written kernel (csrc/fused_encode.cu: corner inputs,
the MLP on the tensor cores and the store in one launch; the
6 -> 64 x 3 -> 8 encoder only, anything else raises ValueError): in
3xTF32 under a float32 ``compute_dtype``, and under bfloat16
(``model.fuse_dtype``) on bfloat16-rounded operands in one TF32 pass,
which is exact for them.  On CPU tensors the plain version runs.  The
kernel reads the weights in ``fused_mlp.pack_params``'s layout, packed
here once per weight set, dtype and device (``pack_encoder``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch import voxel
from bnv_fusion_tpu_torch.kernels import _build
from bnv_fusion_tpu_torch.kernels.fused_mlp import mlp_dims, pack_params

_IN = 6        # offset from the corner (3) + normal (3)
_FEAT = 8      # the one latent width built in csrc/fused_encode.cu
_DTYPES = (torch.float32, torch.bfloat16)
# packed weights by (device, dtype, each weight's storage and version);
# an entry holds its source tensors, so no other tensor takes their storage
# while it lives
_PACKED: Dict[tuple, Tuple[tuple, torch.Tensor]] = {}
_PACKED_MAX = 4


def encode_frame_fm(params, coords_s, normals_s, entry_valid,
                    compute_dtype: torch.dtype = torch.float32):
    """Encoder over one frame's sorted points, FEATURE-MAJOR output [F*8, N]
    with channel = f*8 + p (feature-major, corner-minor) — the layout the
    segmented reduce takes.  Invalid points encode to zero."""
    n = coords_s.shape[0]
    corners = voxel.corner_neighbors(coords_s)
    rel = voxel.local_offsets(coords_s, corners)                 # [N, 8, 3]
    pn_in = torch.cat([rel, normals_s[:, None, :].expand_as(rel)], dim=-1)
    feats = bnn.encoder_apply(params, pn_in, compute_dtype)      # [N, 8, F]
    feats = torch.where(entry_valid[:, None, None], feats,
                        torch.zeros((), device=feats.device))
    return feats.permute(2, 1, 0).reshape(-1, n)


def fused_encode_sorted_torch(params, coords_s, normals_s, entry_valid,
                              compute_dtype: torch.dtype = torch.float32):
    """Plain version: ``encode_frame_fm`` one frame at a time (its [8N, 64]
    activations dominate memory) into [K, 8F, N]."""
    kf, n = coords_s.shape[:2]
    fdim = params["encoder"]["w_out"].shape[1]
    f8fm = torch.empty((kf, 8 * fdim, n), dtype=torch.float32,
                       device=coords_s.device)
    for k in range(kf):
        f8fm[k] = encode_frame_fm(params, coords_s[k], normals_s[k],
                                  entry_valid[k], compute_dtype)
    return f8fm


def check_encoder(enc: Dict[str, torch.Tensor]) -> None:
    """Raise ValueError unless ``enc`` is the 6 -> 64 x 3 -> 8 MLP the
    kernel is built for."""
    din, dout = mlp_dims(enc)
    if (din, dout) != (_IN, _FEAT):
        raise ValueError(f"fused_encode: the kernel takes a {_IN} -> 64 x 3 "
                         f"-> {_FEAT} encoder; got {din} -> {dout}")


def pack_encoder(enc: Dict[str, torch.Tensor], compute_dtype: torch.dtype,
                 device) -> torch.Tensor:
    """The encoder's weights as the kernel reads them on ``device``:
    ``fused_mlp.pack_params`` of the weights rounded to ``compute_dtype``
    (biases as they are).  Packed at the first call for a weight set and
    reused while its tensors are unchanged in place; no host wait."""
    key = (torch.device(device), compute_dtype) + tuple(
        (k, v.data_ptr(), v._version) for k, v in sorted(enc.items()))
    hit = _PACKED.get(key)
    if hit is None:
        check_encoder(enc)
        rounded = {k: bnn.round_to(v, compute_dtype) if k.startswith("w")
                   else v for k, v in enc.items()}
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.pop(next(iter(_PACKED)))
        hit = _PACKED[key] = (tuple(enc.values()),
                              pack_params(rounded, device))
    return hit[1]


@functools.cache
def packed_size() -> int:
    """Floats in the packed layout csrc/fused_encode.cu reads (its kTotal),
    from the built library."""
    return _build.function("fused_encode", "bnv_fused_encode_packed_size",
                           [])()


def fused_encode_sorted(params: Dict[str, Dict[str, torch.Tensor]],
                        coords_s: torch.Tensor, normals_s: torch.Tensor,
                        entry_valid: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Features [K, 8F, N] (channel f*8 + p) of K frames' sorted points
    (coords_s, normals_s [K, N, 3], entry_valid [K, N] bool), zero where
    not entry_valid, with the encoder's operands in ``compute_dtype``."""
    dev = coords_s.device
    if dev.type == "cpu":
        return fused_encode_sorted_torch(params, coords_s, normals_s,
                                         entry_valid, compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_encode: unsupported device {dev}")
    if compute_dtype not in _DTYPES:
        raise ValueError(f"fused_encode: unsupported compute dtype "
                         f"{compute_dtype}")
    _build.check_cuda_tensor(coords_s, "coords_s", torch.float32, 3, dev)
    _build.check_cuda_tensor(normals_s, "normals_s", torch.float32, 3, dev)
    _build.check_cuda_tensor(entry_valid, "entry_valid", torch.bool, 2, dev)
    kf, n = entry_valid.shape
    if tuple(coords_s.shape) != (kf, n, 3) or \
            tuple(normals_s.shape) != (kf, n, 3):
        raise ValueError(f"fused_encode: bad shapes {tuple(coords_s.shape)} "
                         f"{tuple(normals_s.shape)} "
                         f"{tuple(entry_valid.shape)}")
    if not (0 < kf < 2 ** 31 and 0 < n < 2 ** 31):
        raise ValueError(f"fused_encode: unsupported sizes K={kf} N={n}")
    packed = pack_encoder(params["encoder"], compute_dtype, dev)
    if packed.numel() != packed_size():
        raise ValueError(f"fused_encode: the kernel reads {packed_size()} "
                         f"packed floats; pack_params gave {packed.numel()}")
    out = torch.empty((kf, 8 * _FEAT, n), dtype=torch.float32, device=dev)

    P = ctypes.c_void_p
    fn = _build.function("fused_encode", "bnv_fused_encode",
                         [P, P, P, P, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, P, P])
    code = _build.call(fn, dev, P(coords_s.data_ptr()),
                       P(normals_s.data_ptr()), P(entry_valid.data_ptr()),
                       P(packed.data_ptr()), kf, n,
                       int(compute_dtype == torch.bfloat16), P(out.data_ptr()))
    _build.raise_on_error(code, "fused_encode")
    _build.LAUNCHES["fused_encode"] += 1
    return out
