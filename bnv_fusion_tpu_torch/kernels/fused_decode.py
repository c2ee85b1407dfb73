"""Fused SDF corner decode: CUDA kernel + plain version.

Counterpart of bnv_fusion_tpu/kernels/fused_decode.py (``fused_corner_decode``,
the Pallas TPU kernel at :63-99).  ``fused_corner_decode`` launches the
hand-written CUDA kernel (csrc/fused_decode.cu) on CUDA tensors and runs
``fused_corner_decode_torch`` on CPU tensors; any other device raises.
Forward only: the optimization loss keeps the plain decode for autograd.
The kernel runs the hidden layers on the tensor cores in 3xTF32; the weight
packing it reads (hi/lo split, row order, fragment order) is built here, in
``pack_decoder_tc``, so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch.kernels import _build
from bnv_fusion_tpu_torch.kernels.mlp_tc import permute_rows, tc_fragments

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


# Tensor-core packing (csrc/fused_decode.cu, csrc/mlp_tc.cuh; the hi/lo
# split, PERM and the fragment order live in kernels/mlp_tc.py).  Layer 0's
# 24 input columns (17 padded) in the kernel's order: lane t of a row owns
# columns t and t+4 (latents t, t+4), 8+t (l_t), 12+t (sin l_t), 16+t
# (cos l_t) and 20+t (padding); entry = the row of the true w0, -1 = zero.
W0_ROWS = (9, 10, 11, 12, 13, 14, 15, 16,
           0, 1, 2, -1, 3, 4, 5, -1,
           6, 7, 8, -1, -1, -1, -1, -1)


def tc_layer_weights(dec: Dict[str, torch.Tensor]):
    """The three hidden layers' weights as the kernel multiplies them:
    w0 [24, 64] in W0_ROWS order with zero padding rows, w1 and w2
    [64, 64] with their rows permuted by PERM inside each block of 8."""
    w0 = dec["w0"].to(torch.float32)
    rows = torch.tensor([max(r, 0) for r in W0_ROWS], device=w0.device)
    keep = torch.tensor([r >= 0 for r in W0_ROWS], device=w0.device)
    w0l = torch.where(keep[:, None], w0[rows], torch.zeros_like(w0[rows]))
    return [w0l, permute_rows(dec["w1"].to(torch.float32)),
            permute_rows(dec["w2"].to(torch.float32))]


def pack_decoder_tc(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The decoder in csrc/fused_decode.cu's layout: the fragments of the
    three hidden layers (tc_layer_weights, tc_fragments), then b0, b1, b2,
    w_out, b_out in f32, zero-padded to whole float4s (the kernel copies it
    to shared memory in 16-byte loads).  Pack once per weight set and pass
    the result to ``fused_corner_decode``."""
    parts = [tc_fragments(w).reshape(-1) for w in tc_layer_weights(dec)]
    parts += [dec[k].reshape(-1).to(torch.float32)
              for k in ("b0", "b1", "b2", "w_out", "b_out")]
    flat = torch.cat(parts)
    return torch.cat([flat, flat.new_zeros(-flat.numel() % 4)])


@functools.cache
def packed_size() -> int:
    """Floats in the packed layout csrc/fused_decode.cu reads (its kTotal),
    from the built library."""
    return _build.function("fused_decode",
                           "bnv_fused_corner_decode_packed_size", [])()


def fused_corner_decode(params: Dict[str, Any], local: torch.Tensor,
                        feats: torch.Tensor, tw: torch.Tensor,
                        voxel_size: float,
                        packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blended SDF for corner data (local [N,8,3], feats [N,8,F], tw [N,8])
    -> [N]; any N.  Matches decoder_apply + trilinear blend (num_pe_fns=1,
    3 hidden layers).  ``packed`` is ``pack_decoder_tc(params["decoder"])``
    on the inputs' device, built once by a caller that decodes many batches
    with fixed weights; without it the kernel path packs on every call."""
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
    if f != _LATENT:
        raise ValueError(f"fused_corner_decode: latent width {f}, the kernel "
                         f"is built for {_LATENT}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"fused_corner_decode: unsupported point count {n}")
    if packed is None:
        packed = pack_decoder_tc(params["decoder"]).to(dev)
    _build.check_cuda_tensor(packed, "packed", torch.float32, 1, dev)
    if packed.numel() != packed_size() or packed.data_ptr() % 16:
        raise ValueError(f"fused_corner_decode: packed must be "
                         f"pack_decoder_tc's {packed_size()} floats, 16-byte "
                         f"aligned; got {packed.numel()} at "
                         f"{packed.data_ptr():#x}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)

    P = ctypes.c_void_p
    fn = _build.function("fused_decode", "bnv_fused_corner_decode",
                         [P, P, P, P, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, P, P])
    code = _build.call(fn, dev, P(local.data_ptr()), P(feats.data_ptr()),
                       P(tw.data_ptr()), P(packed.data_ptr()), f,
                       float(voxel_size), n, P(out.data_ptr()))
    _build.raise_on_error(code, "fused_corner_decode")
    _build.LAUNCHES["fused_corner_decode"] += 1
    return out
