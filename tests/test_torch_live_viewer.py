"""Port parity of the live viewer: the endpoints of tests/test_live_viewer.py
against the port's viewer, the preview render against the JAX package's,
the port's own PNG writer decoded by cv2 (which the port never imports),
and run_e2e's demo loop publishing each event's mesh."""

import json
import urllib.error
import urllib.request

import cv2
import numpy as np

from bnv_fusion_tpu.utils import vis as jvis
from bnv_fusion_tpu.mesh import Mesh as JMesh
from bnv_fusion_tpu_torch.mesh import Mesh, load_ply
from bnv_fusion_tpu_torch.utils import vis
from bnv_fusion_tpu_torch.utils.live_viewer import LiveViewer


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.read()


def _small_mesh():
    """A closed octahedron and a detached triangle."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                  [0, 0, -1], [2, 2, 0], [2.5, 2, 0], [2, 2.5, 0.5]],
                 np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                  [1, 2, 5], [3, 1, 5], [0, 3, 5], [6, 7, 8]], np.int32)
    return v, f


def test_live_viewer_endpoints(tmp_path):
    viewer = LiveViewer(port=0)
    try:
        code, body = _get(viewer.port, "/")
        assert code == 200 and b"live reconstruction" in body
        for path in ("/mesh.ply", "/preview.png", "/nothing"):
            try:
                code, _ = _get(viewer.port, path)
            except urllib.error.HTTPError as e:
                code = e.code
            assert code == 404, path

        tri = Mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                   np.array([[0, 1, 2]], np.int32))
        viewer.publish(tri, status={"frames": 7})

        code, ply = _get(viewer.port, "/mesh.ply")
        assert code == 200
        p = tmp_path / "got.ply"
        p.write_bytes(ply)
        back = load_ply(str(p))
        np.testing.assert_allclose(back.vertices, tri.vertices)
        np.testing.assert_array_equal(back.faces, tri.faces)

        code, st = _get(viewer.port, "/status.json")
        st = json.loads(st)
        assert st["frames"] == 7 and st["vertices"] == 3

        code, png = _get(viewer.port, "/preview.png")
        assert code == 200 and png[:4] == b"\x89PNG"
    finally:
        viewer.close()
    assert not viewer._thread.is_alive()


def test_render_mesh_preview_matches_jax():
    v, f = _small_mesh()
    got = vis.render_mesh_preview(Mesh(v, f), img_res=(60, 80))
    want = jvis.render_mesh_preview(JMesh(v, f), img_res=(60, 80))
    assert got.dtype == np.uint8 and got.shape == (60, 80, 3)
    assert (got > 0).any()
    np.testing.assert_array_equal(got, want)
    eye = np.array([0.0, -4.0, 1.0])
    np.testing.assert_array_equal(
        vis.render_mesh_preview(Mesh(v, f), img_res=(40, 50), eye=eye),
        jvis.render_mesh_preview(JMesh(v, f), img_res=(40, 50), eye=eye))
    np.testing.assert_array_equal(
        vis.render_mesh_preview(Mesh(v, f[:0]), img_res=(4, 5)),
        np.zeros((4, 5, 3), np.uint8))


def test_png_decodes_to_the_rendered_image():
    v, f = _small_mesh()
    img = vis.render_mesh_preview(Mesh(v, f), img_res=(60, 80))
    back = cv2.imdecode(np.frombuffer(vis.encode_png(img), np.uint8),
                        cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(back[..., ::-1], img)
    # an odd size and arbitrary pixels round-trip too
    noise = np.random.RandomState(0).randint(0, 256, (7, 13, 3)).astype(
        np.uint8)
    back = cv2.imdecode(np.frombuffer(vis.encode_png(noise), np.uint8),
                        cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(back[..., ::-1], noise)


def test_run_e2e_demo_publishes_each_event(monkeypatch, tmp_path):
    """run_e2e with trainer.live_viewer_port publishes every event's mesh
    with its status and stops the server at the end."""
    import socket

    from bnv_fusion_tpu_torch import run_e2e

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    published, closed = [], []
    real_publish, real_close = LiveViewer.publish, LiveViewer.close

    def publish(self, mesh, status=None):
        assert self.port == port
        real_publish(self, mesh, status)
        code, _ = _get(self.port, "/mesh.ply")
        published.append((status["frames"], len(mesh.vertices), code))

    def close(self):
        closed.append(self.port)
        real_close(self)

    monkeypatch.setattr(LiveViewer, "publish", publish)
    monkeypatch.setattr(LiveViewer, "close", close)
    out = run_e2e.run([
        "device_type=cpu", "model.mode=demo", "model.optim_interval=2",
        "dataset.img_res=[60,80]", "dataset.num_images=4",
        "model.voxel_size=0.05", "model.integrate_batch_size=2",
        "dataset.num_pixels=200", "model.train_ray_splits=100",
        "model.min_pts_in_grid=0", "model.table_capacity=65536",
        f"trainer.live_viewer_port={port}", f"output_dir={tmp_path}"])
    assert published == [(e["frame"] + 1, e["vertices"], 200)
                         for e in out["events"]]
    assert len(published) == 2 and closed == [port]
