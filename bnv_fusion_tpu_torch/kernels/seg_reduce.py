"""Segmented reduction over key-sorted streams: CUDA kernel + plain version.

Counterpart of bnv_fusion_tpu/kernels/seg_reduce.py (``seg_reduce_sorted``,
the Pallas TPU kernel at :182-302).  ``seg_reduce_sorted`` launches the
hand-written CUDA kernel (csrc/seg_reduce.cu) on CUDA tensors and runs
``seg_reduce_sorted_torch`` on CPU tensors; any other device raises.  The
kernel streams each payload plane in tiles of ``tile_rows()`` rows, sums the
segments that end inside a tile there, and adds the open sums of segments
that cross tile edges in a fix-up launch (its source has the design).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bnv_fusion_tpu_torch.kernels import _build


@functools.cache
def tile_rows() -> int:
    """Rows per tile of csrc/seg_reduce.cu (its kT), from the built library;
    sizes the wrapper's scratch."""
    return _build.function("seg_reduce", "bnv_seg_reduce_tile_rows", [])()


def seg_reduce_sorted_torch(keys, cnts, vals, u: int, sent: int, keys2=None):
    """Plain PyTorch version of the kernel (same contract, any device).

    Args:
      keys:  [B, M] int32, ascending per row; rows with key >= sent are
             padding and carry all-zero payloads.
      cnts:  [B, n_int, M] int32 channels (exact sums).
      vals:  [B, n_float, M] float32 channels.
      keys2: optional [B, M] secondary key (segment = run of equal
             (key, key2)).
    Returns (keys_u [B,u] i32, keys2_u [B,u] i32 or None,
    cnts_u [B,u,n_int] i32, sums_u [B,u,n_float] f32, n_seg [B] i32 = total
    segments incl. dropped).  Slots past min(n_seg, u) are zero.
    """
    B, M = keys.shape
    n_int, n_float = cnts.shape[1], vals.shape[1]
    dev = keys.device
    valid = keys < sent
    nxt = torch.cat([keys[:, 1:],
                     torch.full((B, 1), sent, dtype=keys.dtype, device=dev)], 1)
    diff = nxt != keys
    if keys2 is not None:
        nxt2 = torch.cat([keys2[:, 1:],
                          torch.zeros((B, 1), dtype=keys2.dtype, device=dev)], 1)
        diff = diff | (nxt2 != keys2)
    is_end = valid & diff
    n_seg = is_end.sum(1).to(torch.int32)
    ends_before = torch.cumsum(is_end.long(), 1)
    rank = ends_before - 1                     # rank of an end row
    seg = ends_before - is_end.long()          # segment of any valid row

    brow = torch.arange(B, device=dev)[:, None]
    keep_end = is_end & (rank < u)
    dump = B * u
    slot = torch.where(keep_end, brow * u + rank, dump).reshape(-1)
    keys_u = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    keys_u[slot] = keys.reshape(-1).to(torch.int32)
    keys_u = keys_u[:dump].reshape(B, u)
    keys2_u = None
    if keys2 is not None:
        k2 = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
        k2[slot] = keys2.reshape(-1).to(torch.int32)
        keys2_u = k2[:dump].reshape(B, u)

    row_slot = torch.where(valid & (seg < u), brow * u + seg, dump).reshape(-1)
    cnts_u = torch.zeros((dump + 1, n_int), dtype=torch.int64, device=dev)
    cnts_u.index_add_(0, row_slot, cnts.permute(0, 2, 1).reshape(B * M, n_int)
                      .long())
    sums_u = torch.zeros((dump + 1, n_float), dtype=torch.float32, device=dev)
    sums_u.index_add_(0, row_slot, vals.permute(0, 2, 1).reshape(B * M, n_float)
                      .float())
    return (keys_u, keys2_u,
            cnts_u[:dump].reshape(B, u, n_int).to(torch.int32),
            sums_u[:dump].reshape(B, u, n_float), n_seg)


def seg_reduce_sorted(keys, cnts, vals, u: int, sent: int, keys2=None):
    """Per-segment sums of a key-sorted stream, compacted to width ``u``
    (contract of ``seg_reduce_sorted_torch``).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    csrc/seg_reduce.cu on the current stream, or raise."""
    if keys.device.type == "cpu":
        return seg_reduce_sorted_torch(keys, cnts, vals, u, sent, keys2=keys2)
    if keys.device.type != "cuda":
        raise ValueError(f"seg_reduce_sorted: unsupported device {keys.device}")
    dev = keys.device
    B, M = keys.shape
    n_int, n_float = cnts.shape[1], vals.shape[1]
    _build.check_cuda_tensor(keys, "keys", torch.int32, 2, dev)
    _build.check_cuda_tensor(cnts, "cnts", torch.int32, 3, dev)
    _build.check_cuda_tensor(vals, "vals", torch.float32, 3, dev)
    if cnts.shape[0] != B or cnts.shape[2] != M or vals.shape[0] != B or \
            vals.shape[2] != M:
        raise ValueError(f"seg_reduce_sorted: payload shapes {tuple(cnts.shape)}"
                         f" / {tuple(vals.shape)} do not match keys {(B, M)}")
    if keys2 is not None:
        _build.check_cuda_tensor(keys2, "keys2", torch.int32, 2, dev)
        if tuple(keys2.shape) != (B, M):
            raise ValueError("seg_reduce_sorted: keys2 shape != keys shape")
    tile = tile_rows()
    if not (0 < M < 2 ** 31 - tile and 0 < u < 2 ** 31 and B < 65536):
        raise ValueError(f"seg_reduce_sorted: unsupported sizes B={B} M={M} "
                         f"u={u}")
    n_tiles = (M + tile - 1) // tile
    # scratch, one allocation: per-tile end counts and first ranks, and each
    # tile's trailing open sums (int and float channels as 32-bit words)
    scratch = torch.empty((B * n_tiles * (2 + n_int + n_float),),
                          dtype=torch.int32, device=dev)
    counts, offsets, partial = scratch.split(
        [B * n_tiles, B * n_tiles, B * n_tiles * (n_int + n_float)])
    keys_u = torch.empty((B, u), dtype=torch.int32, device=dev)
    keys2_u = (torch.empty((B, u), dtype=torch.int32, device=dev)
               if keys2 is not None else None)
    cnts_u = torch.empty((B, u, n_int), dtype=torch.int32, device=dev)
    sums_u = torch.empty((B, u, n_float), dtype=torch.float32, device=dev)
    n_seg = torch.empty((B,), dtype=torch.int32, device=dev)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("seg_reduce", "bnv_seg_reduce_sorted",
                         [P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, P, P,
                          P, P])
    ptr = (lambda t: ctypes.c_void_p(t.data_ptr()) if t is not None
           else ctypes.c_void_p(0))
    code = _build.call(fn, dev, ptr(keys), ptr(keys2), ptr(cnts), ptr(vals),
                       B, M, n_int, n_float, int(u), int(sent), ptr(counts),
                       ptr(offsets), ptr(partial), ptr(keys_u), ptr(keys2_u),
                       ptr(cnts_u), ptr(sums_u), ptr(n_seg))
    _build.raise_on_error(code, "seg_reduce_sorted")
    _build.LAUNCHES["seg_reduce_sorted"] += 1
    return keys_u, keys2_u, cnts_u, sums_u, n_seg
