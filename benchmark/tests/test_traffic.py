"""The torch generator against the system's numpy ray-caster: the same
frames to the millimetre (the system's render_depth, quantised as its
synthetic reader quantises)."""

import json
import os

import numpy as np
import pytest

from benchmark.traffic import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mix,scene", [("orbit_scans", "default_scene"),
                                       ("pan_scans", "room_scene"),
                                       ("orbit_refine", "default_scene")])
def test_frames_match_the_systems_renderer(mix, scene):
    from bnv_fusion_tpu_torch.datasets import synth_scene

    with open(os.path.join(HERE, "traffic", mix + ".json")) as f:
        traffic = dict(json.load(f), frames=5)
    res = (60, 80)
    fr = generator.make_frames(traffic, res, 0.75, 2 ** 40 + 3, "cpu")
    spec = getattr(synth_scene, scene)()
    for i in range(5):
        d = synth_scene.render_depth(spec, fr["T_wc"][i], fr["intr"], res,
                                     traffic["max_depth_m"])
        raw = np.round(d * 1000.0).astype(np.int64)
        assert np.abs(raw - fr["raw"][i].astype(np.int64)).max() <= 1
        assert (raw > 0).mean() > 0.5


def test_seed_moves_the_path_not_the_work():
    with open(os.path.join(HERE, "traffic", "orbit_scans.json")) as f:
        traffic = json.load(f)
    a = generator.camera_path(traffic["path"], 240, 11)
    b = generator.camera_path(traffic["path"], 240, 2 ** 35)
    assert not np.allclose(a, b)
    ra = np.linalg.norm(a[:, :2, 3], axis=1)
    rb = np.linalg.norm(b[:, :2, 3], axis=1)
    assert abs(ra.mean() - rb.mean()) <= 0.02 * 1.6 * 2
    assert np.allclose(generator.camera_path(traffic["path"], 8, 11), a[:8])
