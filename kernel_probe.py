#!/usr/bin/env python3
"""Probe of the port's CUDA kernels on one card.

    python3 kernel_probe.py [--reps N] [--no-profile]

Builds the kernels (printing ptxas's registers, shared memory and spills
for each entry), holds each against its plain version at the main path's
shapes (chip_smoke.py's stage-1 and stage-2 seg-reduce streams, the
decode at N = 2^18 with biased weights, FusedMLP at the encoder's and the
decoder's M), times both (CUDA events, median of N after warm-up), and
splits each kernel's time by pass with one torch.profiler pass (device time
per CUDA kernel name).  Times are the median of single calls (host launch
included, as chip_smoke.py times them), the mean over back-to-back calls
(device-paced) and the host time per call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_name(mangled: str) -> str:
    """``fused_mlp_kernel<1, 1>`` from a mangled entry name: the
    length-prefixed ``*_kernel`` name and its integer or bool template
    arguments."""
    for m in re.finditer(r"(?=(\d+)([a-z][a-z_]*_kernel))", mangled):
        if int(m.group(1)) == len(m.group(2)):
            end = m.start() + len(m.group(1)) + len(m.group(2))
            args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
            if not args:
                return m.group(2)
            vals = re.findall(r"L[a-z](\d+)E", args.group(1))
            return f"{m.group(2)}<{', '.join(vals)}>"
    return mangled[:60]


def ptxas_report(name: str) -> None:
    """Registers, stack frame and spills of each entry of one library, from
    its ``-Xptxas -v`` log."""
    from bnv_fusion_tpu_torch.kernels import _build

    log = _build._paths(name)[2]
    func = frame = None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func, frame = kernel_name(m.group(1)), None
            if "spill" in line:
                frame = line.strip()
            m = re.search(r"Used (\d+) registers.*", line)
            if m and func:
                print(f"  ptxas {name} {func}: {m.group(0).strip()}; "
                      f"{frame}")


def profile_passes(label: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type is not None and "CUDA" in str(ev.device_type) \
                and dev_us > 0:
            rows.append((dev_us / 5, ev.key))
    if not rows:
        print(f"  profile {label}: the profiler shows no device time")
        return
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"  profile {label}: {total / 1e3:.4f} ms of device time per call")
    for us, key in rows:
        print(f"    {us / 1e3:.4f} ms  {key[:90]}")


def back_to_back_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def host_ms(fn, reps: int) -> float:
    """Host time per call, without waiting for the device (the launch queue
    does not fill at these counts)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 1
    from bnv_fusion_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"build: {_build.build()}")
    for name in _build.KERNELS:
        ptxas_report(name)
    probe_seg_reduce(args)
    ok = probe_decode(args)
    return 0 if probe_mlp(args) and ok else 1


def probe_seg_reduce(args) -> None:
    import torch
    import chip_smoke as cs
    from bnv_fusion_tpu_torch.kernels import seg_reduce_sorted

    g = torch.Generator(device="cuda").manual_seed(0)
    sent = 260 * 260 * 160
    for label, shape, u in (("stage 1", (16, 307200, 1, 64, 7000, True),
                             65536),
                            ("stage 2", (16, 524288, 1, 8, 110000, False),
                             116736)):
        keys, keys2, cnts, vals = cs.sorted_stream(*shape[:5], sent, shape[5],
                                                   g)
        err, _, _, nb, nf = cs.check_seg(
            f"seg_reduce {label}", keys, keys2, cnts, vals, u, sent)

        def run():
            return seg_reduce_sorted(keys, cnts, vals, u, sent, keys2=keys2)

        ms = cs.median_ms(run, reps=args.reps)
        bb = back_to_back_ms(run, args.reps)
        b = cs.bound(nb, nf)
        print(f"  seg_reduce {label}: kernel {ms:.4f} ms (back to back "
              f"{bb:.4f} ms, host {host_ms(run, args.reps):.4f} ms per "
              f"call), bound {b[0]:.4f} ms ({b[1]}), "
              f"{100 * b[0] / bb:.0f}% of bound; err {err:.2e}", flush=True)
        if not args.no_profile:
            profile_passes(f"seg_reduce {label}", run)
        del keys, keys2, cnts, vals


def probe_decode(args) -> bool:
    import torch
    import chip_smoke as cs
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (fused_corner_decode,
                                              fused_corner_decode_torch)
    from bnv_fusion_tpu_torch.kernels.fused_decode import pack_decoder_tc

    g = torch.Generator(device="cuda").manual_seed(0)
    params = bnn.init_model(0, device="cuda", bias_std=cs.BIAS_STD)
    n = 1 << 18
    local = torch.rand((n, 8, 3), generator=g, device="cuda") * 2 - 1
    feats = torch.randn((n, 8, 8), generator=g, device="cuda")
    tw = torch.rand((n, 8), generator=g, device="cuda")
    tw = tw / tw.sum(-1, keepdim=True)
    packed = pack_decoder_tc(params["decoder"])

    def dec():
        return fused_corner_decode(params, local, feats, tw, cs.VOXEL, packed)

    ref = fused_corner_decode_torch(params, local, feats, tw, cs.VOXEL)
    err = float((dec() - ref).abs().max())

    ms = cs.median_ms(dec, reps=args.reps)
    print(f"  fused_corner_decode N={n}: kernel {ms:.4f} ms (back to back "
          f"{back_to_back_ms(dec, args.reps):.4f} ms, host "
          f"{host_ms(dec, args.reps):.4f} ms per call), max_abs_err "
          f"{err:.3e} (bound {cs.DECODE_ATOL:.1e})", flush=True)
    if not args.no_profile:
        profile_passes("fused_corner_decode", dec)
    return err <= cs.DECODE_ATOL


def probe_mlp(args) -> bool:
    """FusedMLP at chip_smoke.py's shapes: the encoder (M = 2,457,600,
    6 -> 8) and the decoder (M = 2,097,152, 17 -> 1), biased weights."""
    import ctypes

    import torch
    import chip_smoke as cs
    from bnv_fusion_tpu_torch import nn as bnn
    from bnv_fusion_tpu_torch.kernels import (FusedMLP, _build,
                                              fused_mlp_torch)
    from bnv_fusion_tpu_torch.kernels.fused_mlp import packed_size

    g = torch.Generator(device="cuda").manual_seed(1)
    params = bnn.init_model(0, device="cuda", bias_std=cs.BIAS_STD)
    ok = True
    for name, rows, din in (("encoder", cs.ENC_ROWS, 6),
                            ("decoder", cs.DEC_ROWS, 17)):
        prm = params[name]
        mlp = FusedMLP(prm)
        dout = prm["w_out"].shape[1]
        smem = _build.function("fused_mlp", "bnv_fused_mlp_smem_bytes",
                               [ctypes.c_int, ctypes.c_int])(din, dout)
        print(f"  fused_mlp {name}: {smem} bytes of dynamic shared memory "
              f"per block ({4 * packed_size(din, dout)} of packed weights)",
              flush=True)
        x = torch.randn((rows, din), generator=g, device="cuda")
        ref = fused_mlp_torch(prm, x)
        y = mlp(x)
        err = (y - ref).abs()
        ok &= not bool((err > cs.MLP_ATOL + cs.MLP_RTOL * ref.abs()).any())

        def run():
            return mlp(x)

        ms = cs.median_ms(run, reps=args.reps)
        bb = back_to_back_ms(run, args.reps)
        b = cs.mlp_bounds(prm, x, y)[0]
        print(f"  fused_mlp {name} M={rows} {din}->{y.shape[1]}: kernel "
              f"{ms:.4f} ms (back to back {bb:.4f} ms, host "
              f"{host_ms(run, args.reps):.4f} ms per call), bound "
              f"{b[0]:.4f} ms ({b[1]}), {100 * b[0] / bb:.0f}% of bound; "
              f"max_abs_err {float(err.max()):.3e}", flush=True)
        if not args.no_profile:
            profile_passes(f"fused_mlp {name}", run)
        del x, y, ref
    return ok


if __name__ == "__main__":
    sys.exit(main())
