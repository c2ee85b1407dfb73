"""Port parity of the JAX package's API residue (ROADMAP item 17):
render.composite_occupancy (bnv_fusion_tpu/render.py:130-145, against the
JAX function and tests/test_render.py:117's case) and the native mesher's
plain binding, native.available / marching_tetrahedra_native
(bnv_fusion_tpu/native/__init__.py:69-98), mirroring the 9 tests of
tests/test_native_mesh.py on the port's numpy mesher and holding the
binding bit for bit against the JAX package's (both build the same C++
entry point).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import native as jnative
from bnv_fusion_tpu import render as jrender
from bnv_fusion_tpu_torch import mesh as m
from bnv_fusion_tpu_torch import native
from bnv_fusion_tpu_torch import render as trender


def test_composite_occupancy_picks_first_surface():
    n, s = 3, 10
    d = np.tile(np.linspace(0.1, 1.0, s), (n, 1)).astype(np.float32)
    pts = np.zeros((n, s, 3), np.float32)
    pts[..., 2] = d
    occ = np.zeros((n, s), np.float32)
    occ[:, 4] = 1.0  # opaque at sample 4
    expected, depth_prob, background = trender.composite_occupancy(
        torch.as_tensor(pts), torch.as_tensor(occ),
        torch.as_tensor(d[..., None]))
    np.testing.assert_allclose(expected.numpy()[:, 2], d[:, 4], atol=1e-6)
    np.testing.assert_allclose(background.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(depth_prob.numpy()[:, 4], 1.0, atol=1e-6)


def test_composite_occupancy_matches_jax(rng):
    """Random occupancies: the same products and sums, float32 roundoff."""
    pts = rng.randn(16, 12, 3).astype(np.float32)
    occ = rng.rand(16, 12).astype(np.float32)
    dists = np.sort(rng.rand(16, 12, 1).astype(np.float32), axis=1)
    got = trender.composite_occupancy(torch.as_tensor(pts),
                                      torch.as_tensor(occ),
                                      torch.as_tensor(dists))
    want = jrender.composite_occupancy(jnp.asarray(pts), jnp.asarray(occ),
                                       jnp.asarray(dists))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _sphere_cells(radius=5.0, extent=8):
    rng = np.arange(-extent, extent)
    origins = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                       axis=-1).reshape(-1, 3)
    corners = origins[:, None, :] + m._CUBE_CORNERS[None, :, :]
    sdf = (np.linalg.norm(corners, axis=-1) - radius).astype(np.float32)
    return origins, sdf


@pytest.fixture(scope="module")
def native_ok():
    assert native.available()
    return True


@pytest.mark.parametrize("tol", [0.0, 1e-3, 0.5])
def test_native_matches_jax_binding(native_ok, tol):
    """The port's binding and the JAX package's on the same cells: the
    same vertices and faces, bit for bit, welded or not."""
    assert jnative.available()
    origins, sdf = _sphere_cells()
    v, f = native.marching_tetrahedra_native(origins, sdf, tol)
    jv, jf = jnative.marching_tetrahedra_native(origins, sdf, tol)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_native_matches_numpy_triangles(native_ok):
    origins, sdf = _sphere_cells()
    ref = m.marching_tetrahedra(origins, sdf)
    verts, faces = native.marching_tetrahedra_native(origins, sdf, 0.0)
    # unwelded native output: identical triangle soup (same order)
    np.testing.assert_allclose(
        verts[faces].reshape(-1, 9),
        ref.vertices[ref.faces].reshape(-1, 9), atol=1e-5)


def test_native_weld_reduces_vertices(native_ok):
    origins, sdf = _sphere_cells()
    v0, f0 = native.marching_tetrahedra_native(origins, sdf, 0.0)
    v1, f1 = native.marching_tetrahedra_native(origins, sdf, 1e-3)
    assert len(v1) < len(v0)
    r = np.linalg.norm(v1, axis=-1)
    assert abs(r.mean() - 5.0) < 0.05


def test_native_orientation_outward(native_ok):
    origins, sdf = _sphere_cells()
    v, f = native.marching_tetrahedra_native(origins, sdf, 1e-3)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(b - a, c - a)
    centroid = (a + b + c) / 3
    nondeg = np.linalg.norm(n, axis=-1) > 1e-9
    assert ((n * centroid).sum(-1)[nondeg] > 0).all()


def test_extract_mesh_native_path():
    vs = 0.05
    min_coords = np.array([-1.0, -1.0, -1.0], np.float32)
    rng = np.arange(0, 40)
    g = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), -1).reshape(-1, 3)
    world = g * vs + min_coords
    d = np.abs(np.linalg.norm(world, axis=-1) - 0.5)
    active = g[d < 2 * vs].astype(np.int32)

    def decode_fn(coords):
        w = np.asarray(coords) * vs + min_coords
        return (np.linalg.norm(w, axis=-1) - 0.5).astype(np.float32)

    for use_native in (True, False):
        out = m.extract_mesh(decode_fn, active, min_coords, vs,
                             batch_size=8192, use_native=use_native)
        r = np.linalg.norm(out.vertices, axis=-1)
        assert abs(r.mean() - 0.5) < 0.005


def test_build_sample_lattice_native_parity(native_ok):
    rng = np.random.RandomState(3)
    coords = np.unique(rng.randint(-40, 40, size=(4000, 3)), axis=0)
    for scale in (2, 4):
        a = m.build_sample_lattice(coords, scale, use_native=False)
        b = m.build_sample_lattice(coords, scale, use_native=True)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_native_weld_packed_vs_unpacked(native_ok):
    origins, sdf = _sphere_cells()
    off = 1 << 21                       # beyond the packed-key precheck
    v_small, f_small = native.marching_tetrahedra_native(origins, sdf, 0.5)
    v_big, f_big = native.marching_tetrahedra_native(origins + off, sdf, 0.5)
    assert v_small.shape == v_big.shape
    assert np.array_equal(f_small, f_big)
    np.testing.assert_allclose(v_small + off, v_big, rtol=1e-6)


def test_native_weld_matches_reference_merge(native_ok):
    origins, sdf = _sphere_cells()
    tol = 0.5
    v_nat, f_nat = native.marching_tetrahedra_native(origins, sdf, tol)
    ref = m.marching_tetrahedra(origins, sdf)
    merged = m.merge_vertices(m.Mesh(ref.vertices, ref.faces), tol)
    assert len(v_nat) == len(merged.vertices)
    a = {tuple(np.round(v, 4)) for v in v_nat}
    b = {tuple(np.round(v, 4)) for v in merged.vertices}
    assert a == b


def _lattice(ext, radius):
    r = np.arange(-ext, ext)
    cells = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    pr = np.arange(-ext, ext + 1)
    pts = np.stack(np.meshgrid(pr, pr, pr, indexing="ij"), -1).reshape(-1, 3)
    sdf = (np.linalg.norm(pts, axis=-1) - radius).astype(np.float32)
    side = 2 * ext + 1
    c = cells[:, None, :] + m._CUBE_CORNERS[None]
    corner_idx = (((c[..., 0] + ext) * side + (c[..., 1] + ext)) * side +
                  (c[..., 2] + ext)).astype(np.int64)
    return cells, corner_idx, sdf


def test_native_indexed_matches_plain(native_ok):
    """The indexed mesher (gather + crossing gate in C++) equals gathering
    and compacting in numpy, then the plain binding, with and without the
    NaN observation sentinel."""
    rng = np.random.RandomState(7)
    cells, corner_idx, sdf = _lattice(8, 5.0)
    sdf_nan = sdf.copy()
    sdf_nan[rng.rand(len(sdf)) < 0.2] = np.nan
    fallback = np.float32(0.05)
    for sentinel, s in ((False, sdf), (True, sdf_nan)):
        cell_sdf = s[corner_idx]
        if sentinel:
            observed = ~np.isnan(cell_sdf)
            crossing = ((np.where(observed, cell_sdf, np.inf).min(1) < 0) &
                        (np.where(observed, cell_sdf, -np.inf).max(1) > 0))
            cell_sdf = np.where(observed, cell_sdf, fallback)
        else:
            crossing = (cell_sdf.min(1) < 0) & (cell_sdf.max(1) > 0)
        for tol in (0.0, 0.5):
            v_ref, f_ref = native.marching_tetrahedra_native(
                cells[crossing], cell_sdf[crossing], tol)
            v_idx, f_idx = native.marching_tetrahedra_indexed_native(
                cells, corner_idx, s, use_sentinel=sentinel,
                nan_fallback=fallback, weld_tol=tol)
            assert np.array_equal(v_ref, v_idx), (sentinel, tol)
            assert np.array_equal(f_ref, f_idx), (sentinel, tol)
        assert crossing.sum() > 100


def test_native_indexed_face_cells(native_ok):
    cells, corner_idx, sdf = _lattice(6, 4.0)
    v, f, fc = native.marching_tetrahedra_indexed_native(
        cells, corner_idx, sdf, use_sentinel=False, nan_fallback=0.0,
        weld_tol=0.0, return_cell_ids=True)
    assert len(fc) == len(f)
    cell_sdf = sdf[corner_idx]
    crossing = (cell_sdf.min(1) < 0) & (cell_sdf.max(1) > 0)
    ref, tri_cell = m.marching_tetrahedra(cells[crossing], cell_sdf[crossing],
                                          return_cell_ids=True)
    assert np.array_equal(cells[fc], cells[crossing][tri_cell])
    assert np.allclose(ref.vertices[ref.faces], v[f])
    tri = v[f]
    lo = cells[fc][:, None, :].astype(np.float32)
    assert (tri >= lo - 1e-5).all() and (tri <= lo + 1 + 1e-5).all()
