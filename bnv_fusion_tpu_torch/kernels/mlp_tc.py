"""Weight packing for the 64-wide tensor-core MLP tile (csrc/mlp_tc.cuh).

The Python side of ``csrc/mlp_tc.cuh``, shared by the two kernels built on
it (``fused_decode.pack_decoder_tc``, ``fused_mlp.pack_params``).  A layer
of K inputs and 8 * NT outputs is multiplied as ``mma.m16n8k8`` TF32
products in 3xTF32: its weights are split once per weight set into TF32
hi/lo parts and laid out in the B-fragment order the kernels load.
"""

from __future__ import annotations

import torch

# Inside each block of 8, the A fragment's column kk is the accumulator's
# column PERM[kk] (mlp_tc.cuh), so a layer that reads the previous layer's
# accumulators has its weight rows permuted so.
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def permute_rows(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] (K a multiple of 8) with row 8j + kk taken from row
    8j + PERM[kk]: the weights of a layer whose A operand is the previous
    layer's accumulators."""
    k = w.shape[0]
    perm = torch.tensor([8 * (i // 8) + PERM[i % 8] for i in range(k)],
                        device=w.device)
    return w[perm]


def split_tf32(x: torch.Tensor):
    """x -> (hi, lo) with hi = tf32(x), lo = tf32(x - hi), both rounded to
    nearest with ties away from zero (PTX cvt.rna.tf32.f32): the low 13 of
    f32's 23 mantissa bits are rounded off."""
    def rna(v):
        b = v.contiguous().view(torch.int32)
        return ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x.to(torch.float32))
    return hi, rna(x.to(torch.float32) - hi)


def tc_fragments(w: torch.Tensor) -> torch.Tensor:
    """[K, 8 * NT] (K a multiple of 8) -> [K/8, NT, 32, 4]: for k-step j,
    n-tile n and lane = 4g + t, the float4 (hi b0, hi b1, lo b0, lo b1) with
    b0 = w[8j+t, 8n+g], b1 = w[8j+t+4, 8n+g] (PTX's B fragment of
    mma.m16n8k8 .tf32)."""
    k, n = w.shape
    hi, lo = split_tf32(w)
    x = torch.stack([hi, lo])                      # [hl, K, N]
    x = x.reshape(2, k // 8, 2, 4, n // 8, 8)      # [hl, j, half, t, n, g]
    return x.permute(1, 4, 5, 3, 0, 2).reshape(k // 8, n // 8, 32, 4)


def pad_to(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """w [r, c] zero-padded to [rows, cols] (f32)."""
    out = torch.zeros((rows, cols), dtype=torch.float32, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out
