"""Port parity of the optimize-overlapped mesh-lattice prefetch
(``NeuralMap.prefetch_mesh_lattice``, ``_prefetched_lattice``,
``extract_mesh``'s lattice branch, ``mesh.cell_owner_voxel`` and
``mesh.extract_mesh(lattice=)``) against the JAX package.

``optimize`` starts a host build of the sample lattice over every allocated
voxel; ``extract_mesh`` filters its cells to the post-optimize gate by each
cell's owner voxel.  Every cell has exactly one owner, so the mesh must be
BIT-IDENTICAL to the in-line build: vertices and faces compared with
array_equal.  The prefetched lattice itself is integer data and must equal
the JAX package's exactly on the same table.

Operating point: tests/test_torch_e2e.py's (60x80, voxel 0.05, 200 rays,
2 optimize steps) with min_pts_in_grid 1, so the optimize's weight bumps
decide the gate and the gated voxels are a strict subset of the lattice's;
the untrained decoder's output bias is shifted by the median decoded value,
as that test does, so the level set crosses the map.
"""

import jax
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import mesh as jmesh
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import mesh as tmesh
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

VOXEL = 0.05
BASE = ["dataset.img_res=[60,80]", "dataset.num_images=4",
        f"model.voxel_size={VOXEL}", "dataset.num_pixels=200",
        "model.train_ray_splits=100", "model.min_pts_in_grid=1",
        "model.table_capacity=65536", "model.use_seg_reduce_kernel=interpret",
        "model.fuse_sort_bf16=false"]


@pytest.fixture(scope="module")
def stream():
    ds = SyntheticDemoDataset(jload_config(BASE), "val")
    return dict(frames=[ds[i] for i in range(len(ds))], dims=ds.dimensions)


def _fused_map(stream, extra=(), n_frames=4):
    """A port map over the first n_frames (K=2 batches), its decoder bias
    shifted so the untrained level set crosses the map."""
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0))
    nm = TNeuralMap(stream["dims"], tload_config(
        BASE + list(extra) + ["device_type=cpu"]), params)
    frames = stream["frames"][:n_frames]
    for i in range(0, len(frames), 2):
        nm.integrate_batch(frames[i:i + 2])
    keys = ttables.active_entries(nm.table, with_features=False)[0]
    with torch.no_grad():
        sdf = tfusion.decode_points(
            nm.table.features, nm.table, nm.params,
            torch.as_tensor(keys + 0.5, dtype=torch.float32), nm.bound_min,
            VOXEL, 0, is_coords=True)
    nm.params["decoder"]["b_out"] -= float(np.median(sdf.numpy()) / VOXEL)
    return nm


@pytest.mark.parametrize("scale", [2, 4])
def test_cell_owner_voxel_roundtrip(scale):
    """Every cell of a built lattice maps back to a generating voxel, each
    voxel owns exactly scale^3 cells, and the owners equal the JAX
    package's."""
    rng = np.random.RandomState(0)
    coords = np.unique(rng.randint(0, 12, size=(64, 3)).astype(np.int32),
                       axis=0)
    _, _, cells = tmesh.build_sample_lattice(coords, scale)
    owners = tmesh.cell_owner_voxel(cells, scale)
    np.testing.assert_array_equal(owners, jmesh.cell_owner_voxel(cells, scale))
    have = {tuple(c) for c in coords}
    assert all(tuple(o) in have for o in owners)
    uniq, counts = np.unique(owners, axis=0, return_counts=True)
    assert len(uniq) == len(coords) and (counts == scale ** 3).all()


def test_prefetched_lattice_matches_jax(stream, tmp_path):
    """The same saved map loaded by both packages: the prefetched lattice
    (points, corner indices, cells) and each cell's owner row are equal."""
    nm = _fused_map(stream)
    nm.save(str(tmp_path / "map"))
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0))
    jnm = JNeuralMap(stream["dims"], jload_config(BASE), params)
    jnm.load_map(str(tmp_path / "map"))
    tnm = TNeuralMap(stream["dims"], tload_config(BASE + ["device_type=cpu"]),
                     params)
    tnm.load_map(str(tmp_path / "map"))
    jnm.prefetch_mesh_lattice()
    tnm.prefetch_mesh_lattice()
    jbox, tbox = jnm._prefetched_lattice(), tnm._prefetched_lattice()
    assert jbox is not None and tbox is not None and tbox["n"] == jbox["n"]
    for a, b in zip(tbox["lattice"], jbox["lattice"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbox["owner_rows"], jbox["owner_rows"])


@pytest.mark.parametrize("use_delta", [True, False])
def test_prefetched_mesh_identical(stream, use_delta):
    """fuse -> optimize -> extract_mesh from the prefetched lattice, then
    again with model.mesh_prefetch=false (the in-line build) on the same
    state: identical vertices and faces."""
    nm = _fused_map(stream)
    nm.optimize(2)
    box = nm._prefetched_lattice()
    assert box is not None
    n = box["n"]
    gate = nm._mesh_weights(nm.table.weights[:n].numpy(),
                            nm.table.num_hits[:n].numpy()) >= 1
    assert 0 < gate.sum() < n          # the gate filters the lattice
    pre = nm.extract_mesh(use_delta=use_delta)
    nm.config.model.mesh_prefetch = False
    assert nm._prefetched_lattice() is None
    inline = nm.extract_mesh(use_delta=use_delta)
    assert pre is not None and len(pre.faces) > 100
    np.testing.assert_array_equal(pre.vertices, inline.vertices)
    np.testing.assert_array_equal(pre.faces, inline.faces)


def test_prefetch_invalidated_by_new_frames(stream):
    """Fusing after the prefetch moves the fuse epoch: in both packages the
    prefetch is no longer used, and the in-line mesh still comes out.  The
    port's prefetch starts in optimize; the JAX side calls the method its
    optimize calls first."""
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0))
    jnm = JNeuralMap(stream["dims"], jload_config(BASE), params)
    tnm = _fused_map(stream, n_frames=2)
    jnm.integrate_batch(stream["frames"][:2])
    for nm, start in ((jnm, jnm.prefetch_mesh_lattice),
                      (tnm, lambda: tnm.optimize(2))):
        start()
        assert nm._prefetched_lattice() is not None
        nm.integrate_batch(stream["frames"][2:])
        assert nm._prefetched_lattice() is None
    m = tnm.extract_mesh()
    assert m is not None and len(m.faces) > 0


def test_mesh_prefetch_false_starts_nothing(stream):
    """model.mesh_prefetch=false: the prefetch is a no-op in both packages,
    and the port's optimize starts none."""
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(0))
    extra = ["model.mesh_prefetch=false"]
    jnm = JNeuralMap(stream["dims"], jload_config(BASE + extra), params)
    jnm.integrate_batch(stream["frames"][:2])
    tnm = _fused_map(stream, extra, n_frames=2)
    for nm, start in ((jnm, jnm.prefetch_mesh_lattice),
                      (tnm, lambda: tnm.optimize(1))):
        start()
        assert nm._mesh_prefetch is None
