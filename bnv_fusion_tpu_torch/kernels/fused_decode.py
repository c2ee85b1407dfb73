"""Fused SDF corner decode: CUDA kernel + plain version.

Counterpart of bnv_fusion_tpu/kernels/fused_decode.py (``fused_corner_decode``,
the Pallas TPU kernel at :63-99).  ``fused_corner_decode`` launches the
hand-written CUDA kernel (csrc/fused_decode.cu) on CUDA tensors and runs
``fused_corner_decode_torch`` on CPU tensors; any other device raises.
Forward only: the optimization loss keeps the plain decode for autograd.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch.kernels import _build

_HIDDEN = 64
_LATENT = 8    # the one width built in csrc/fused_decode.cu (every config's)


def fused_decode_available(params: Dict[str, Any]) -> bool:
    """The kernel supports the tcnn topology: PE of a 3-vector (9) plus an
    8-dim latent, 3 hidden layers of 64, 1-d output."""
    dec = params.get("decoder", {})
    if not all(k in dec for k in ("w0", "w1", "w2", "w_out", "b0", "b1", "b2",
                                  "b_out")) or "w3" in dec:
        return False
    din, hid = dec["w0"].shape
    return (hid == _HIDDEN and din - 9 == _LATENT and
            tuple(dec["w1"].shape) == (_HIDDEN, _HIDDEN) and
            tuple(dec["w2"].shape) == (_HIDDEN, _HIDDEN) and
            tuple(dec["w_out"].shape) == (_HIDDEN, 1))


def fused_corner_decode_torch(params: Dict[str, Any], local: torch.Tensor,
                              feats: torch.Tensor, tw: torch.Tensor,
                              voxel_size: float) -> torch.Tensor:
    """Plain version: decoder_apply over the 8 corners + trilinear blend.
    local [N,8,3], feats [N,8,F], tw [N,8] -> [N]."""
    alpha = bnn.decoder_apply(params, local, feats)[..., 0]
    return torch.sum(alpha * voxel_size * tw, dim=-1)


def _pack_decoder(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([dec["w0"].reshape(-1), dec["b0"].reshape(-1),
                      dec["w1"].reshape(-1), dec["b1"].reshape(-1),
                      dec["w2"].reshape(-1), dec["b2"].reshape(-1),
                      dec["w_out"].reshape(-1), dec["b_out"].reshape(-1)]
                     ).to(torch.float32).contiguous()


def fused_corner_decode(params: Dict[str, Any], local: torch.Tensor,
                        feats: torch.Tensor, tw: torch.Tensor,
                        voxel_size: float) -> torch.Tensor:
    """Blended SDF for corner data (local [N,8,3], feats [N,8,F], tw [N,8])
    -> [N]; any N.  Matches decoder_apply + trilinear blend (num_pe_fns=1,
    3 hidden layers)."""
    if local.device.type == "cpu":
        return fused_corner_decode_torch(params, local, feats, tw, voxel_size)
    if local.device.type != "cuda":
        raise ValueError(f"fused_corner_decode: unsupported device "
                         f"{local.device}")
    if not fused_decode_available(params):
        raise ValueError("fused_corner_decode: decoder topology not supported "
                         "by the kernel (see fused_decode_available)")
    dev = local.device
    n = local.shape[0]
    f = feats.shape[-1] if feats.dim() == 3 else -1
    _build.check_cuda_tensor(local, "local", torch.float32, 3, dev)
    _build.check_cuda_tensor(feats, "feats", torch.float32, 3, dev)
    _build.check_cuda_tensor(tw, "tw", torch.float32, 2, dev)
    if tuple(local.shape) != (n, 8, 3) or tuple(feats.shape) != (n, 8, f) or \
            tuple(tw.shape) != (n, 8):
        raise ValueError(f"fused_corner_decode: bad shapes {tuple(local.shape)}"
                         f" {tuple(feats.shape)} {tuple(tw.shape)}")
    packed = _pack_decoder(params["decoder"]).to(dev)
    if packed.numel() != (9 + f) * _HIDDEN + 2 * _HIDDEN * _HIDDEN + \
            4 * _HIDDEN + 1:
        raise ValueError("fused_corner_decode: decoder width does not match "
                         f"the latent width {f}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"fused_corner_decode: unsupported point count {n}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)

    lib = _build.load("fused_decode")
    fn = lib.bnv_fused_corner_decode
    fn.restype = ctypes.c_int
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_float, ctypes.c_int, P, P]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(P(local.data_ptr()), P(feats.data_ptr()), P(tw.data_ptr()),
                  P(packed.data_ptr()), f, float(voxel_size), n,
                  P(out.data_ptr()), P(stream))
    _build.raise_on_error(code, "fused_corner_decode")
    _build.LAUNCHES["fused_corner_decode"] += 1
    return out
