"""Port parity: RGB fusion (``model.fuse_color``) against the JAX package: the
colour running mean of ``tsdf.integrate`` / ``integrate_windowed``,
``tsdf.sample_color``, the colour volume of a ``fuse_color`` NeuralMap
through each fuse route, and the vertex colours of ``extract_mesh``.

Frames: the synthetic stream at 60x80 with ``dataset.load_color=true``
(``procedural_albedo`` colours); weights ``init_model(seed, bias_std=0.1)``.
The JAX module functions run eagerly (``jax.disable_jit``), as the port
does; the JAX NeuralMap runs its jitted steps.

Tolerances:
* ``integrate`` / ``integrate_windowed``: sdf and weight within 1e-5 and
  colour within 1e-4 (0-255 units) of JAX's.  A voxel whose projection lands
  within float noise of a pixel's edge (the two frameworks' 3x3 products
  differ in the last bit; 2.5e-6 px here) rounds to the neighbouring pixel on
  one side and takes that pixel's colour, while its sdf, clipped to 1 in
  front of the surface, agrees.  So, as tests/test_torch_fusion.py's prior
  check, at most 0.1% of the voxels may differ in colour (0.03% here);
* ``sample_color``: bit-equal uint8;
* a ``fuse_color`` NeuralMap (merged K=2 batches at tsdf_every=2, the
  unmerged per-frame route, per-frame ``integrate``): weights equal, colour
  within 1e-3 on all but at most 0.1% of the voxels (the same pixel edges);
* uint8 colour against the same values as float32, in the port: bit-equal
  colour volumes;
* ``extract_mesh``: each package's vertex colours equal the other
  package's ``sample_color`` of the same colour volume at the same vertices,
  bit for bit, and at least 99.9% of the port's equal JAX's sampling of JAX's
  own volume (the volumes differ as above); a PLY round trip keeps them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnv_fusion_tpu import tsdf as jtsdf
from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu.datasets.synth_scene import SyntheticDemoDataset
from bnv_fusion_tpu.pipeline import NeuralMap as JNeuralMap
from bnv_fusion_tpu_torch import fusion as tfusion
from bnv_fusion_tpu_torch import mesh as tmesh
from bnv_fusion_tpu_torch import nn as tnn
from bnv_fusion_tpu_torch import tables as ttables
from bnv_fusion_tpu_torch import tsdf as ttsdf
from bnv_fusion_tpu_torch.config import load_config as tload_config
from bnv_fusion_tpu_torch.pipeline import NeuralMap as TNeuralMap

t = torch.as_tensor
VS_T = 0.05
OVERRIDES = ["dataset.img_res=[60,80]", "dataset.num_images=4",
             "model.voxel_size=0.05", "dataset.num_pixels=200",
             "model.train_ray_splits=100", "model.min_pts_in_grid=0",
             "model.table_capacity=65536",
             "model.use_seg_reduce_kernel=interpret",
             "model.fuse_sort_bf16=false", "model.fuse_color=true",
             "dataset.load_color=true", "model.tsdf_voxel_size=0.05"]


@pytest.fixture(scope="module")
def stream():
    ds = SyntheticDemoDataset(jload_config(OVERRIDES), "val")
    frames = [ds[i] for i in range(len(ds))]
    assert frames[0]["rgb"].shape == (60, 80, 3)
    return ds, frames


@pytest.mark.parametrize("windowed", [False, True], ids=["full", "windowed"])
def test_integrate_rgb_matches_jax(stream, windowed):
    ds, frames = stream
    jvol, _ = jtsdf.create_tsdf_volume(ds.dimensions, VS_T, with_color=True)
    tvol, _ = ttsdf.create_tsdf_volume(ds.dimensions, VS_T, with_color=True)
    assert tvol.color.shape == tvol.sdf.shape + (3,)
    f0 = frames[0]
    window = ttsdf.frustum_window_shape(f0["intr_mat"], f0["depth"].shape,
                                        0.8, VS_T, tvol.sdf.shape)
    assert np.prod(window) < np.prod(tvol.sdf.shape)
    with jax.disable_jit():
        for f in frames:
            args = (f["depth"], f["intr_mat"], f["T_wc"])
            if windowed:
                jvol = jtsdf.integrate_windowed(
                    jvol, *map(jnp.asarray, args), VS_T, window, 0.8,
                    obs_weight=2.0, rgb=jnp.asarray(f["rgb"]))
                ttsdf.integrate_windowed(tvol, *map(t, args), VS_T, window,
                                         0.8, obs_weight=2.0, rgb=t(f["rgb"]))
            else:
                jvol = jtsdf.integrate(jvol, *map(jnp.asarray, args), VS_T,
                                       obs_weight=2.0,
                                       rgb=jnp.asarray(f["rgb"]))
                ttsdf.integrate(tvol, *map(t, args), VS_T, obs_weight=2.0,
                                rgb=t(f["rgb"]))
    jw = np.asarray(jvol.weight)
    assert (jw > 0).sum() > 1000
    np.testing.assert_allclose(tvol.weight.numpy(), jw, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvol.sdf.numpy(), np.asarray(jvol.sdf),
                               atol=1e-5, rtol=0)
    _check_color(tvol.color.numpy(), np.asarray(jvol.color), jw, 1e-4)


def _check_color(tc, jc, jw, atol):
    """Colour volumes: within atol on all but at most 0.1% of the voxels."""
    assert jc[jw > 0].std() > 10
    bad = np.abs(tc - jc).max(-1) > atol
    assert bad.mean() <= 1e-3, bad.sum()


def test_color_running_mean_and_volumes_without_color():
    """Two frames in red then blue average to (100, 0, 50) where observed;
    a volume made without colour ignores rgb."""
    h, w = 60, 80
    intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                    np.float32)
    depth = np.full((h, w), 1.0, np.float32)
    vol, _ = ttsdf.create_tsdf_volume(np.array([3.0, 3.0, 3.0]), 0.05,
                                      with_color=True)
    red = np.zeros((h, w, 3), np.float32)
    red[..., 0] = 200.0
    blue = np.zeros((h, w, 3), np.float32)
    blue[..., 2] = 100.0
    for rgb in (red, blue):
        ttsdf.integrate(vol, t(depth), t(intr), torch.eye(4), 0.05,
                        rgb=t(rgb))
    obs = vol.weight.numpy() > 0
    assert obs.any()
    c = vol.color.numpy()[obs]
    np.testing.assert_allclose(c, np.broadcast_to([100.0, 0.0, 50.0],
                                                  c.shape), atol=1e-3)
    plain, _ = ttsdf.create_tsdf_volume(np.array([2.0, 2.0, 2.0]), 0.05)
    ttsdf.integrate(plain, t(depth), t(intr), torch.eye(4), 0.05, rgb=t(red))
    assert plain.color is None
    with pytest.raises(ValueError, match="without color"):
        ttsdf.sample_color(plain, torch.zeros((2, 3)), 0.05)


def test_sample_color_bit_equal_to_jax(stream):
    ds = stream[0]
    rng = np.random.RandomState(0)
    jvol, _ = jtsdf.create_tsdf_volume(ds.dimensions, VS_T, with_color=True)
    color = (rng.rand(*jvol.color.shape) * 255).astype(np.float32)
    # half-integer values exercise round-half-to-even
    color[::3] = np.floor(color[::3]) + 0.5
    jvol = jvol.replace(color=jnp.asarray(color))
    tvol, _ = ttsdf.create_tsdf_volume(ds.dimensions, VS_T, with_color=True)
    tvol.color = t(color)
    # inside the grid, outside it (clipped) and on voxel centres
    pts = rng.uniform(-1.6, 1.6, (5000, 3)).astype(np.float32)
    pts[:500] = (np.round(pts[:500] / VS_T) * VS_T).astype(np.float32)
    with jax.disable_jit():
        j = np.asarray(jtsdf.sample_color(jvol, jnp.asarray(pts), VS_T))
    tc = ttsdf.sample_color(tvol, t(pts), VS_T)
    assert tc.dtype == torch.uint8 and tc.shape == (5000, 3)
    np.testing.assert_array_equal(tc.numpy(), j)


def _maps(extra, route):
    """Both packages' fuse_color NeuralMaps after the 4 frames through
    ``route``."""
    ds = SyntheticDemoDataset(jload_config(OVERRIDES), "val")
    frames = [ds[i] for i in range(len(ds))]
    params = jax.tree.map(lambda x: x.numpy(), tnn.init_model(2, bias_std=0.1))
    jnm = JNeuralMap(ds.dimensions, jload_config(OVERRIDES + extra), params)
    tnm = TNeuralMap(ds.dimensions,
                     tload_config(OVERRIDES + extra + ["device_type=cpu"]),
                     params)
    for nm in (jnm, tnm):
        if route == "integrate":
            for f in frames:
                nm.integrate(f)
        else:
            for i in range(0, len(frames), 2):
                nm.integrate_batch(frames[i:i + 2])
    return ds, params, jnm, tnm


@pytest.mark.parametrize("route,extra", [
    ("merged", ["model.tsdf_every=2"]),
    ("unmerged", ["model.fuse_batch_merge=false"]),
    ("integrate", []),
])
def test_neural_map_color_volume_matches_jax(route, extra):
    _, _, jnm, tnm = _maps(extra, route)
    jw = np.asarray(jnm.tsdf_vol.weight)
    np.testing.assert_array_equal(tnm.tsdf_vol.weight.numpy(), jw)
    _check_color(tnm.tsdf_vol.color.numpy(), np.asarray(jnm.tsdf_vol.color),
                 jw, 1e-3)


@pytest.mark.parametrize("route,extra", [
    ("merged", ["model.tsdf_every=2"]),
    ("unmerged", ["model.fuse_batch_merge=false"]),
    ("integrate", []),
])
def test_uint8_rgb_equals_float_rgb(stream, route, extra):
    """uint8 colour (a camera's) stays uint8 on the host and gives the colour
    volume of the same values as float32, bit for bit; the merged route
    stages only the colour of the frames the prior reads."""
    ds, frames = stream
    q = [dict(f, rgb=np.round(f["rgb"]).astype(np.uint8)) for f in frames]
    qf = [dict(f, rgb=f["rgb"].astype(np.float32)) for f in q]
    cfg = tload_config(OVERRIDES + extra + ["device_type=cpu"])
    vols = []
    for fs in (q, qf):
        nm = TNeuralMap(ds.dimensions, cfg, tnn.init_model(2, bias_std=0.1))
        if route == "integrate":
            for f in fs:
                nm.integrate(f)
        else:
            for i in range(0, len(fs), 2):
                nm.integrate_batch(fs[i:i + 2])
        vols.append(nm.tsdf_vol.color.numpy())
    assert vols[0].std() > 10
    np.testing.assert_array_equal(vols[0], vols[1])
    staged = nm._stack_batch(q, rgb_every=2)
    assert staged["rgb"].dtype == np.uint8
    np.testing.assert_array_equal(staged["rgb"],
                                  np.stack([q[0]["rgb"], q[2]["rgb"]]))


def test_frame_without_rgb_raises():
    cfg = tload_config(OVERRIDES + ["device_type=cpu"])
    ds = SyntheticDemoDataset(jload_config(OVERRIDES), "val")
    nm = TNeuralMap(ds.dimensions, cfg, tnn.init_model(0))
    frame = dict(ds[0])
    del frame["rgb"]
    with pytest.raises(ValueError, match="neither 'rgb' nor"):
        nm.integrate(frame)
    frame["img_path"] = "/nonexistent/frame.png"
    with pytest.raises(ValueError, match="neither 'rgb' nor"):
        nm.integrate_batch([frame, frame])


def test_extract_mesh_colors_match_jax(tmp_path):
    """The meshes of the two packages differ in float rounding, so each
    mesh's colours are held against the other package's sampling of its
    own prior at the same vertices."""
    ds, params, jnm, tnm = _maps([], "merged")
    # untrained weights decode an SDF of one sign almost everywhere: shift
    # the decoder's output bias by the median decoded value at the voxel
    # centres so the level set crosses the map (as tests/test_torch_e2e.py
    # does), on both sides
    keys = ttables.active_entries(tnm.table, with_features=False)[0]
    with torch.no_grad():
        sdf = tfusion.decode_points(
            tnm.table.features, tnm.table, tnm.params,
            t(keys + 0.5, dtype=torch.float32), tnm.bound_min,
            tnm.voxel_size, 0, is_coords=True)
    params["decoder"]["b_out"] = params["decoder"]["b_out"] - \
        np.float32(np.median(sdf.numpy()) / tnm.voxel_size)
    jnm.params = jax.tree.map(jnp.asarray, params)
    tnm.params["decoder"]["b_out"] = t(params["decoder"]["b_out"])
    with jax.disable_jit():
        jmesh = jnm.extract_mesh()
    tm = tnm.extract_mesh()
    assert tm is not None and jmesh is not None and len(tm.vertices) > 100
    assert tm.colors.dtype == np.uint8 and tm.colors.shape == \
        tm.vertices.shape
    assert tm.colors.astype(np.float32).std() > 10
    # each mesh's colours are the other package's sampling of the same
    # prior at its vertices, bit for bit
    jvol = jnm.tsdf_vol.replace(color=jnp.asarray(tnm.tsdf_vol.color.numpy()))
    with jax.disable_jit():
        want = np.asarray(jtsdf.sample_color(jvol, jnp.asarray(tm.vertices),
                                             jnm.tsdf_voxel_size))
        across = np.asarray(jtsdf.sample_color(
            jnm.tsdf_vol, jnp.asarray(tm.vertices), jnm.tsdf_voxel_size))
    np.testing.assert_array_equal(tm.colors, want)
    tvol = ttsdf.TSDFVolume(tnm.tsdf_vol.sdf, tnm.tsdf_vol.weight,
                            tnm.tsdf_vol.origin,
                            t(np.asarray(jnm.tsdf_vol.color)))
    back = ttsdf.sample_color(tvol, t(np.asarray(jmesh.vertices)),
                              tnm.tsdf_voxel_size).numpy()
    np.testing.assert_array_equal(np.asarray(jmesh.colors), back)
    # against JAX's own prior: off only where its colour volume differs
    # (float noise and the pixel-edge voxels above)
    assert (tm.colors == across).mean() >= 0.999

    path = os.path.join(tmp_path, "colored.ply")
    tmesh.save_ply(path, tm)
    loaded = tmesh.load_ply(path)
    np.testing.assert_array_equal(loaded.colors, tm.colors)
    np.testing.assert_array_equal(loaded.vertices, tm.vertices)
    post = tmesh.post_process_mesh(tm, tnm.voxel_size / 4)
    assert post.colors is not None and len(post.colors) == len(post.vertices)
