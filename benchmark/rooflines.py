"""The yardstick's counts: operations and bytes that a call's inputs need,
and the card's peaks.

Work is counted once, from what the inputs need, whatever implements it:
each input byte read once and each output byte written once, each
multiply-add of the configuration's float32 arithmetic as 2 operations
(bias, activation and blend are left out), against NVIDIA's published peaks
of one H100 SXM: 495 TFLOP/s dense TF32 (the highest rate at which it
multiplies float32 operands) and 3.35 TB/s of HBM3.  So no float32-accurate
implementation can read above 100%, and a share does not change when the
kernel that does the work changes.  The arithmetic of a bound (the larger
of the two times) is that of the system's chip_smoke.py ``bound`` and
``nbytes``, recounted this way.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

PEAK_FLOPS = 495e12      # H100 SXM, dense TF32
PEAK_BYTES = 3.35e12     # H100 SXM, HBM3


def macs(dims: Sequence[int]) -> int:
    """Multiply-adds of one MLP evaluation with these layer widths."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def encoder_flops(points: int, dims: Sequence[int]) -> float:
    """The PointNet encoder on ``points`` points, one evaluation per corner
    of each (8)."""
    return float(points) * 8 * 2 * macs(dims)


def decoder_flops(samples: int, dims: Sequence[int],
                  backward_to_inputs: bool = False) -> float:
    """The decoder at ``samples`` points, one evaluation per corner (8);
    with the backward to its inputs (the weights frozen), twice that."""
    return float(samples) * 8 * 2 * macs(dims) * (2 if backward_to_inputs
                                                   else 1)


def seg_stage_bytes(rows: int, valid_rows: int, n_keys: int, n_int: int,
                    n_float: int, segments: int) -> float:
    """One frame's segmented reduction: every row's keys are read (they
    delimit the segments), the payload of the rows with a valid key, and
    each produced segment's keys and sums plus the segment count written."""
    return 4.0 * (rows * n_keys + valid_rows * (n_int + n_float) +
                  segments * (n_keys + n_int + n_float) + 1)


def fuse_seg_reduce_bytes(pixels: int, inside: int, groups: int,
                          voxels: int, u_cell: int, u: int,
                          fdim: int) -> float:
    """Both seg-reduce launches' bytes for one frame of the K-frame fuse:
    stage 1 over the frame's points sorted by (cell, corner code) with one
    count and 8 x F feature channels, stage 2 over 8 rows per compacted
    cell group, keyed by corner voxel, one count and F channels."""
    g = min(groups, u_cell)
    stage1 = seg_stage_bytes(pixels, inside, 2, 1, 8 * fdim, g)
    stage2 = seg_stage_bytes(8 * u_cell, 8 * g, 1, 1, fdim, min(voxels, u))
    return stage1 + stage2


def decode_bytes(points: int, fdim: int, decoder_dims: Sequence[int]) -> float:
    """The fused corner decode of ``points`` points: corner offsets
    [N, 8, 3], latents [N, 8, F] and blend weights [N, 8] read, the SDF [N]
    written, the decoder's weights and biases read once."""
    weights = macs(decoder_dims) + sum(decoder_dims[1:])
    return 4.0 * (points * (8 * 3 + 8 * fdim + 8 + 1) + weights)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def layer_dims(net: Dict) -> Dict[str, List[int]]:
    """Widths of both MLPs from a configuration's ``network`` group."""
    hidden = [int(net["hidden"])] * int(net["hidden_layers"])
    pe = 3 + 2 * 3 * int(net["pe_fns"])
    return {"encoder": [int(net["pointnet_in"])] + hidden +
            [int(net["feature_dims"])],
            "decoder": [pe + int(net["feature_dims"])] + hidden + [1]}
