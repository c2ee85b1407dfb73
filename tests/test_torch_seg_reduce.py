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

