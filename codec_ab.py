#!/usr/bin/env python3
"""The host codec's JPEG decode time, for an A/B of two checkouts of the
repository.

    python3 codec_ab.py <checkout> [--reps N]

builds <checkout>'s `bnv_fusion_tpu_torch/native/image_ops.cpp` as the
port builds it (`native.load_library`'s flags) into a temporary directory,
decodes each 240x320 frame of this repository's
tests/data/torch_image_modes through the library's C interface (header,
then decode: the bytes in memory, no EXIF or resize), and prints one line:

    AB <checkout name> <frame> <median ms of N decodes> ...

with "refused" for a frame that checkout does not decode, then the card's
name and power limit.  Alternate the checkouts in one call (parent,
change, change, parent): host load drifts over a call, and two calls land
on different hosts.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = ("frame_base.jpg", "frame_prog.jpg", "frame_cmyk.jpg",
          "frame_sof9.jpg", "frame_sof10.jpg", "frame_smooth.jpg")


def decode_ms(lib, data: bytes, reps: int):
    """Median ms of `reps` decodes of data, or None if the codec refuses
    it."""
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    info = (ctypes.c_int32 * 3)()
    if lib.image_ops_jpeg_header(buf, len(data), info) != 0:
        return None
    out = (ctypes.c_uint8 * (info[0] * info[1] * 3))()
    times = []
    for _ in range(reps + 1):     # the first is a warm-up
        t0 = time.perf_counter()
        rc = lib.image_ops_jpeg_decode(buf, len(data), out, info[0], info[1])
        times.append((time.perf_counter() - t0) * 1e3)
        if rc != 0:
            return None
    times = sorted(times[1:])
    return times[len(times) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    src = os.path.join(os.path.abspath(args.checkout), "bnv_fusion_tpu_torch",
                       "native", "image_ops.cpp")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libimage_ops.so")
        subprocess.run(["c++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
                        "-o", so], check=True)
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.image_ops_jpeg_header.argtypes = [u8p, ctypes.c_int64,
                                              ctypes.POINTER(ctypes.c_int32)]
        lib.image_ops_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                              ctypes.c_int64, ctypes.c_int64]
        fields = []
        for name in FRAMES:
            with open(os.path.join(HERE, "tests", "data", "torch_image_modes",
                                   name), "rb") as f:
                ms = decode_ms(lib, f.read(), args.reps)
            fields.append(f"{name} {'refused' if ms is None else f'{ms:.4f}'}")
    card = "no card"
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    print(f"AB {os.path.basename(os.path.abspath(args.checkout))} "
          f"{' '.join(fields)} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
