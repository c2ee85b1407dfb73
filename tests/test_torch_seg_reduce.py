"""Port parity: the plain segmented reduce of bnv_fusion_tpu_torch against the
JAX package's Pallas kernel (interpret mode on CPU) and its numpy oracle,
over the cases of tests/test_seg_reduce.py.

Tolerances: keys, int sums and segment counts exact; float sums within
rtol = atol = 1e-5, the bound test_seg_reduce.py holds the Pallas kernel to
(the plain version sums each segment in row order, the Pallas kernel by a
log-step segmented scan, the oracle in float64).  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu.kernels.seg_reduce import (seg_reduce_sorted,
                                               seg_reduce_sorted_ref)
from bnv_fusion_tpu_torch.kernels import seg_reduce as tseg

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_case(rng, B, M, n_int, n_float, sent, n_keys, frac_valid=0.8,
                 max_run=9):
    keys = np.full((B, M), sent, np.int32)
    cnts = np.zeros((B, n_int, M), np.int32)
    vals = np.zeros((B, n_float, M), np.float32)
    for b in range(B):
        n_valid = int(M * frac_valid)
        ks = np.sort(rng.choice(n_keys, size=n_valid // 2, replace=False))
        runs = rng.randint(1, max_run, size=ks.shape[0])
        flat = np.repeat(ks, runs)[:n_valid]
        keys[b, :len(flat)] = flat
        cnts[b, :, :len(flat)] = rng.randint(0, 100, size=(n_int, len(flat)))
        vals[b, :, :len(flat)] = rng.randn(n_float, len(flat))
    return keys, None, cnts, vals


def _spanning(rng):
    M = 2048
    keys = np.concatenate([np.arange(100, dtype=np.int32),
                           np.full(1500, 500, np.int32),
                           np.arange(1000, 1000 + 448, dtype=np.int32)])[None]
    cnts = rng.randint(0, 5, size=(1, 1, M)).astype(np.int32)
    vals = rng.randn(1, 2, M).astype(np.float32)
    return keys, None, cnts, vals


def _overflow(rng):
    M = 1024
    keys = np.arange(M, dtype=np.int32)[None]
    return keys, None, np.ones((1, 1, M), np.int32), \
        rng.randn(1, 1, M).astype(np.float32)


def _two_keys(rng):
    M, sent = 1024, 1 << 16
    base = np.sort(rng.choice(1000, size=300, replace=True)).astype(np.int32)
    sub = rng.randint(0, 3, size=300).astype(np.int32)
    order = np.lexsort((sub, base))
    keys = np.full((1, M), sent, np.int32)
    keys2 = np.zeros((1, M), np.int32)
    keys[0, :300] = base[order]
    keys2[0, :300] = sub[order]
    cnts = np.zeros((1, 1, M), np.int32)
    vals = np.zeros((1, 2, M), np.float32)
    cnts[0, :, :300] = rng.randint(0, 10, size=(1, 300))
    vals[0, :, :300] = rng.randn(2, 300)
    return keys, keys2, cnts, vals


def _long_runs(rng):
    """M = 1000 (not a multiple of the model's 64-row tile): short runs, a
    200-row run from row 60 over tiles 0-4 (tiles 1-3 hold no end, between
    tiles with ends), a 150-row run, more short runs, then padding."""
    M, sent = 1000, 1 << 16
    runs = [3, 5, 52, 200, 7, 1, 1, 150] + list(rng.randint(1, 9, size=80))
    flat = np.repeat(np.arange(len(runs), dtype=np.int32) * 3, runs)[:900]
    keys = np.full((2, M), sent, np.int32)
    cnts = np.zeros((2, 2, M), np.int32)
    vals = np.zeros((2, 3, M), np.float32)
    for b in range(2):
        n = len(flat) - 37 * b
        keys[b, :n] = flat[:n] + b
        cnts[b, :, :n] = rng.randint(0, 100, size=(2, n))
        vals[b, :, :n] = rng.randn(3, n)
    return keys, None, cnts, vals


def _all_sentinel(rng):
    M = 512
    return (np.full((1, M), 100, np.int32), None,
            np.zeros((1, 1, M), np.int32), np.zeros((1, 1, M), np.float32))


# (case builder, u, sent, tile of the Pallas run)
CASES = {
    "random_b1": (lambda r: _random_case(r, 1, 4096, 2, 3, 10_000, 10_000),
                  1024, 10_000, 512),
    "random_b2": (lambda r: _random_case(r, 2, 2048, 2, 3, 10_000, 10_000),
                  512, 10_000, 512),
    "random_b8": (lambda r: _random_case(r, 8, 1024, 2, 3, 10_000, 10_000),
                  512, 10_000, 256),
    "ragged_m": (lambda r: _random_case(r, 1, 2500, 2, 3, 10_000, 10_000),
                 2048, 10_000, 512),
    "spanning_many_tiles": (_spanning, 1024, 1 << 20, 256),
    "overflow_keeps_first_u": (_overflow, 64, 1 << 16, 256),
    "two_keys": (_two_keys, 512, 1 << 16, 256),
    "all_sentinel": (_all_sentinel, 16, 100, 256),
    # segments over >= 3 tiles of 64 rows, ragged M; then the same stream
    # with fewer slots than segments, cut inside a tile
    "long_runs_ragged": (_long_runs, 512, 1 << 16, 256),
    "long_runs_overflow": (_long_runs, 7, 1 << 16, 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_oracle(case):
    build, u, sent, tile = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    keys, keys2, cnts, vals = build(rng)
    two = keys2 is not None

    tk, tk2, tc, ts, tn = tseg.seg_reduce_sorted_torch(
        torch.as_tensor(keys), torch.as_tensor(cnts), torch.as_tensor(vals),
        u, sent, keys2=None if keys2 is None else torch.as_tensor(keys2))
    jk, jk2, jc, js, jn = seg_reduce_sorted(
        jnp.asarray(keys), jnp.asarray(cnts), jnp.asarray(vals), u=u,
        sent=sent, keys2=None if keys2 is None else jnp.asarray(keys2),
        tile=tile, interpret=True, two_keys=two)
    rk, rk2, rc, rs, rn = seg_reduce_sorted_ref(keys, cnts, vals, u, sent,
                                                keys2=keys2)

    np.testing.assert_array_equal(tn.numpy(), rn)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for b in range(keys.shape[0]):
        n = min(int(rn[b]), u)
        for mine, jax_out, ref in ((tk, jk, rk), (tc, jc, rc)):
            np.testing.assert_array_equal(mine[b, :n].numpy(), ref[b, :n])
            np.testing.assert_array_equal(mine[b, :n].numpy(),
                                          np.asarray(jax_out)[b, :n])
        if two:
            np.testing.assert_array_equal(tk2[b, :n].numpy(), rk2[b, :n])
        np.testing.assert_allclose(ts[b, :n].numpy(), rs[b, :n], **TOL)
        np.testing.assert_allclose(ts[b, :n].numpy(), np.asarray(js)[b, :n],
                                   **TOL)
        # slots past min(n_seg, u) are zeroed by the port
        assert not tk[b, n:].any() and not ts[b, n:].any()


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(0)
    keys, _, cnts, vals = _random_case(rng, 2, 512, 1, 2, 1000, 1000)
    args = (torch.as_tensor(keys), torch.as_tensor(cnts),
            torch.as_tensor(vals), 128, 1000)
    a = tseg.seg_reduce_sorted(*args)
    b = tseg.seg_reduce_sorted_torch(*args)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


def _tile_sums(rows, end, n_keep, rows_per_thread, lanes):
    """One tile of csrc/seg_reduce.cu's tile_sums for one payload type, in
    the kernel's order of adds: rows [tile, C] (uint32 wraps like the int
    channels, float32 rounds like the float ones), end [tile] the rows that
    end a segment.  Returns the sums at the tile's ranks [n_keep, C] and the
    tile's trailing open sum [C]."""
    C = rows.shape[1]
    zero = np.zeros(C, rows.dtype)
    stage = np.zeros((n_keep, C), rows.dtype)
    n_thr = rows.shape[0] // rows_per_thread
    # walk_rows: each thread sums its rows serially; the first end's sum
    # waits for the carry, later ends' sums are final; x = the open sum
    x, first, has_end, rank = [], [], [], []
    slot = 0
    for th in range(n_thr):
        xt, ft, r0 = zero, zero, slot
        for i in range(th * rows_per_thread, (th + 1) * rows_per_thread):
            xt = xt + rows[i]
            if end[i]:
                if slot == r0:
                    ft = xt
                elif slot < n_keep:
                    stage[slot] = xt
                slot += 1
                xt = zero
        x.append(xt)
        first.append(ft)
        has_end.append(slot > r0)
        rank.append(r0)
    # scan_chunk: a Hillis-Steele segmented scan over each warp's lanes,
    # then the warps' aggregates in warp order
    incl_x, incl_f = list(x), list(has_end)
    for w0 in range(0, n_thr, lanes):
        d = 1
        while d < lanes:
            nx, nf = list(incl_x), list(incl_f)
            for i in range(w0 + d, w0 + lanes):
                if not incl_f[i]:
                    nx[i] = incl_x[i - d] + incl_x[i]
                nf[i] = incl_f[i] or incl_f[i - d]
            incl_x, incl_f = nx, nf
            d *= 2
    carry_in, c = [], zero
    for w0 in range(0, n_thr, lanes):
        carry_in.append(c)
        last = w0 + lanes - 1
        c = incl_x[last] if incl_f[last] else c + incl_x[last]
    for th in range(n_thr):
        if has_end[th] and rank[th] < n_keep:
            cw = carry_in[th // lanes]
            if th % lanes == 0:
                cin = cw
            elif incl_f[th - 1]:
                cin = incl_x[th - 1]
            else:
                cin = cw + incl_x[th - 1]
            stage[rank[th]] = cin + first[th]
    last = n_thr - 1
    part = incl_x[last] if incl_f[last] else carry_in[-1] + incl_x[last]
    return stage, part


def _tiled_model(keys, keys2, cnts, vals, u, sent, tile, rows_per_thread,
                 lanes):
    """numpy model of csrc/seg_reduce.cu's passes at a given tile shape:
    per-tile end counts and their scan (ranks), the in-tile sums and
    trailing open sums of _tile_sums, and the fix-up that adds the trailing
    sums of the preceding tiles (back to the last tile with an end) into a
    tile's first segment, in tile order.  Int channels wrap like int32,
    float channels are summed in float32, in the kernel's order."""
    B, M = keys.shape
    n_int, n_float = cnts.shape[1], vals.shape[1]
    nxt = np.concatenate([keys[:, 1:], np.full((B, 1), sent, keys.dtype)], 1)
    end = (keys < sent) & (nxt != keys)
    if keys2 is not None:
        nxt2 = np.concatenate([keys2[:, 1:], np.zeros((B, 1), keys2.dtype)], 1)
        end |= (keys < sent) & (nxt2 != keys2)
    n_tiles = -(-M // tile)
    counts = np.add.reduceat(end, np.arange(0, M, tile), axis=1).astype(int)
    offsets = np.cumsum(counts, 1) - counts
    n_seg = counts.sum(1)
    keys_u = np.zeros((B, u), np.int32)
    keys2_u = np.zeros((B, u), np.int32)
    outs = [np.zeros((B, u, n_int), np.uint32),
            np.zeros((B, u, n_float), np.float32)]
    pad = n_tiles * tile - M
    for b in range(B):
        e = np.concatenate([end[b], np.zeros(pad, bool)])
        where = np.flatnonzero(end[b])[:u]
        keys_u[b, :len(where)] = keys[b, where]
        if keys2 is not None:
            keys2_u[b, :len(where)] = keys2[b, where]
        for out, payload in zip(outs, (cnts[b].view(np.uint32), vals[b])):
            rows = np.concatenate([payload.T, np.zeros((pad, out.shape[2]),
                                                       out.dtype)])
            parts = []
            for t in range(n_tiles):
                base = offsets[b, t]
                n_keep = max(0, min(u - base, counts[b, t]))
                stage, part = _tile_sums(rows[t * tile:(t + 1) * tile],
                                         e[t * tile:(t + 1) * tile], n_keep,
                                         rows_per_thread, lanes)
                out[b, base:base + n_keep] = stage
                parts.append(part)
            for t in range(1, n_tiles):
                r0 = offsets[b, t]
                if counts[b, t] == 0 or r0 >= u:
                    continue
                j0 = t - 1
                while j0 > 0 and counts[b, j0] == 0:
                    j0 -= 1
                s_ = np.zeros(out.shape[2], out.dtype)
                for j in range(j0, t):
                    s_ = s_ + parts[j]
                out[b, r0] = out[b, r0] + s_
    return (keys_u, keys2_u, outs[0].view(np.int32), outs[1],
            n_seg.astype(np.int32))


# (rows per tile, rows per thread, lanes per warp): a small tile of four
# 4-lane warps, and the kernel's own (csrc/seg_reduce.cu's kT: 128 threads
# of kR = 8 rows, 32-lane warps)
@pytest.mark.parametrize("tile,rows_per_thread,lanes",
                         [(64, 4, 4), (1024, 8, 32)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_model_matches_plain_and_pallas(case, tile, rows_per_thread,
                                              lanes):
    """The CUDA kernel's tiling (modelled at a small tile and at the
    kernel's own) against the plain version and the Pallas kernel."""
    build, u, sent, pallas_tile = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    keys, keys2, cnts, vals = build(rng)
    two = keys2 is not None
    mk, mk2, mc, ms, mn = _tiled_model(keys, keys2, cnts, vals, u, sent,
                                       tile, rows_per_thread, lanes)
    tk, tk2, tc, ts, tn = tseg.seg_reduce_sorted_torch(
        torch.as_tensor(keys), torch.as_tensor(cnts), torch.as_tensor(vals),
        u, sent, keys2=None if keys2 is None else torch.as_tensor(keys2))
    jk, _, jc, js, jn = seg_reduce_sorted(
        jnp.asarray(keys), jnp.asarray(cnts), jnp.asarray(vals), u=u,
        sent=sent, keys2=None if keys2 is None else jnp.asarray(keys2),
        tile=pallas_tile, interpret=True, two_keys=two)
    np.testing.assert_array_equal(mn, tn.numpy())
    np.testing.assert_array_equal(mn, np.asarray(jn))
    # the model writes every slot (zeros past min(n_seg, u)), like the kernel
    np.testing.assert_array_equal(mk, tk.numpy())
    np.testing.assert_array_equal(mc, tc.numpy())
    np.testing.assert_allclose(ms, ts.numpy(), **TOL)
    if two:
        np.testing.assert_array_equal(mk2, tk2.numpy())
    for b in range(keys.shape[0]):
        n = min(int(mn[b]), u)
        np.testing.assert_array_equal(mk[b, :n], np.asarray(jk)[b, :n])
        np.testing.assert_array_equal(mc[b, :n], np.asarray(jc)[b, :n])
        np.testing.assert_allclose(ms[b, :n], np.asarray(js)[b, :n], **TOL)
    if case.startswith("long_runs") and tile == 64:
        # the case exercises what it is named for
        counts = np.add.reduceat(
            (keys < sent) & (np.concatenate(
                [keys[:, 1:], np.full((keys.shape[0], 1), sent)], 1) != keys),
            np.arange(0, keys.shape[1], 64), axis=1)
        assert keys.shape[1] % 64 and (counts[0, 1:4] == 0).all() and \
            counts[0, 0] and counts[0, 4]
        assert case != "long_runs_overflow" or (mn > u).all()
