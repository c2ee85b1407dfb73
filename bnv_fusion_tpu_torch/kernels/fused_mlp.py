"""Fused ReLU MLP: CUDA kernel + plain version.

Counterpart of bnv_fusion_tpu/kernels/fused_mlp.py (``FusedMLP`` and the
Pallas TPU kernel ``fused_mlp_feature_major`` at :79).  ``FusedMLP(params)(x)``
equals ``nn.mlp_apply(params, x)`` for x [..., din].  The TPU kernel's
feature-major layout is a lane-padding workaround and is not kept: the CUDA
kernel (csrc/fused_mlp.cu) takes row-major rows.  On CUDA tensors the kernel
runs (the tcnn topology only: 3 hidden layers of 64, din <= 32, dout <= 16;
anything else raises ValueError); on CPU tensors the plain version runs, for
any topology.  Forward only, like the TPU kernel.  The kernel runs its
layers on the tensor cores in 3xTF32 (csrc/mlp_tc.cuh); the weight packing
it reads (hi/lo split, row order, fragment order) is built here, in
``pack_params``, so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from bnv_fusion_tpu_torch import nn as bnn
from bnv_fusion_tpu_torch.kernels import _build
from bnv_fusion_tpu_torch.kernels.mlp_tc import (pad_to, permute_rows,
                                                 tc_fragments)

_HIDDEN = 64
_N_HIDDEN = 3
_MAX_IN = 32
_MAX_OUT = 16


def fused_mlp_torch(params: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version: nn.mlp_apply."""
    return bnn.mlp_apply(params, x)


def mlp_dims(params: Dict[str, torch.Tensor]):
    """(din, dout) of an MLP the kernel supports; ValueError otherwise."""
    names = {f"w{i}" for i in range(_N_HIDDEN)} | {"w_out"}
    if {k for k in params if k.startswith("w")} != names:
        raise ValueError("fused_mlp: the kernel takes 3 hidden layers "
                         f"(w0..w2, w_out); got {sorted(params)}")
    din, hid = params["w0"].shape
    dout = params["w_out"].shape[1]
    if hid != _HIDDEN or not 1 <= din <= _MAX_IN or \
            not 1 <= dout <= _MAX_OUT or \
            any(tuple(params[f"w{i}"].shape) != (_HIDDEN, _HIDDEN)
                for i in (1, 2)) or \
            tuple(params["w_out"].shape) != (_HIDDEN, dout):
        raise ValueError(
            f"fused_mlp: unsupported topology {din} -> "
            f"{[tuple(params[k].shape) for k in sorted(names)]} (the kernel "
            f"takes din <= {_MAX_IN} -> 64 x 3 -> dout <= {_MAX_OUT})")
    return int(din), int(dout)


def tiles(din: int, dout: int):
    """(KS0, NT) of csrc/fused_mlp.cu: layer 0's k-steps (din padded to
    8 * KS0) and the output layer's n-tiles (dout padded to 8 * NT; 0 for
    dout = 1, whose output layer runs on FMAs)."""
    return -(-din // 8), (0 if dout == 1 else -(-dout // 8))


def pack_params(params: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """The kernel's weight layout, one f32 vector on ``device``: the
    fragments (mlp_tc.tc_fragments) of the layers the kernel multiplies on
    the tensor cores: w0 [8 * KS0, 64] zero-padded (rows in input-column
    order), w1 and w2 with rows permuted by PERM inside each block of 8,
    and for dout >= 2 w_out [64, 8 * NT], rows permuted, columns
    zero-padded; for dout = 1 w_out's 64 floats as they are (the FMA output
    layer reads the accumulators' own columns).  Then b0, b1, b2 and b_out
    (zero-padded to 8 * NT for dout >= 2), the whole zero-padded to whole
    float4s (the kernel copies it to shared memory in 16-byte loads)."""
    din, dout = mlp_dims(params)
    ks0, nt = tiles(din, dout)
    f32 = {k: v.to(device=device, dtype=torch.float32)
           for k, v in params.items()}
    ws = [pad_to(f32["w0"], 8 * ks0, _HIDDEN), permute_rows(f32["w1"]),
          permute_rows(f32["w2"])]
    if nt:
        ws.append(permute_rows(pad_to(f32["w_out"], _HIDDEN, 8 * nt)))
    parts = [tc_fragments(w).reshape(-1) for w in ws]
    if not nt:
        parts.append(f32["w_out"].reshape(-1))
    parts += [f32[f"b{i}"].reshape(-1) for i in range(_N_HIDDEN)]
    parts.append(pad_to(f32["b_out"].reshape(1, -1), 1,
                        8 * nt if nt else 1).reshape(-1))
    flat = torch.cat(parts)
    return torch.cat([flat, flat.new_zeros(-flat.numel() % 4)]).contiguous()


@functools.cache
def packed_size(din: int, dout: int) -> int:
    """Floats in the packed layout csrc/fused_mlp.cu reads for (din, dout),
    from the built library."""
    return _build.function("fused_mlp", "bnv_fused_mlp_packed_size",
                           [ctypes.c_int, ctypes.c_int])(din, dout)


def fused_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              packed: torch.Tensor | None = None) -> torch.Tensor:
    """mlp_apply(params, x) for x [..., din] -> [..., dout]: the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors.  ``packed`` is
    ``pack_params(params, x.device)``, reused across calls by FusedMLP."""
    if x.device.type == "cpu":
        return fused_mlp_torch(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    din, dout = mlp_dims(params)
    if x.shape[-1] != din:
        raise ValueError(f"fused_mlp: input width {x.shape[-1]} != {din}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_mlp: expected float32, got {x.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, din).contiguous()
    m = x2.shape[0]
    if packed is None:
        packed = pack_params(params, x.device)
    _build.check_cuda_tensor(packed, "packed", torch.float32, 1, x.device)
    size = packed_size(din, dout)
    if packed.numel() != size or packed.data_ptr() % 16:
        raise ValueError(f"fused_mlp: packed must be pack_params's {size} "
                         f"floats, 16-byte aligned; got {packed.numel()} at "
                         f"{packed.data_ptr():#x}")
    out = torch.empty((m, dout), dtype=torch.float32, device=x.device)
    if m == 0:
        return out.reshape(lead + (dout,))

    P = ctypes.c_void_p
    fn = _build.function("fused_mlp", "bnv_fused_mlp",
                         [P, P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          P, P])
    code = _build.call(fn, x.device, P(x2.data_ptr()), P(packed.data_ptr()),
                       din, dout, m, P(out.data_ptr()))
    _build.raise_on_error(code, "fused_mlp")
    _build.LAUNCHES["fused_mlp"] += 1
    return out.reshape(lead + (dout,))


class FusedMLP:
    """FusedMLP(params)(x [..., din]) matches nn.mlp_apply(params, x)
    (the JAX package's row-major API).  The packed weights are built once
    per device."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = params
        self.din = int(params["w0"].shape[0])
        self.dout = int(params["w_out"].shape[1])
        self._packed: Dict[torch.device, torch.Tensor] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return fused_mlp(self.params, x)
        if x.device not in self._packed:
            self._packed[x.device] = pack_params(self.params, x.device)
        return fused_mlp(self.params, x, self._packed[x.device])
