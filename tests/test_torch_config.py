"""The port's yaml-free config reader against PyYAML, and its composition
against the JAX package's load_config."""

import glob
import os

import pytest
import yaml

from bnv_fusion_tpu.config import load_config as jload_config
from bnv_fusion_tpu_torch.config import (_parse_value, load_config,
                                         parse_yaml)

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
FILES = sorted(os.path.relpath(p, CONFIG_DIR) for p in glob.glob(
    os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("rel", FILES)
def test_reader_matches_safe_load(rel):
    with open(os.path.join(CONFIG_DIR, rel)) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "[480,640]", "true", "False", "0.01", "116736", "auto", "1e-08", "1.0e-8",
    "null", "~", "[a, 1, 2.5, [x, y]]", '"quoted # not a comment"', "0/2",
    "-3", ".5", "{}", "[]", "yes", "off", "0o17", "1_000"])
def test_override_values_parse_like_yaml(text):
    assert _parse_value(text) == yaml.safe_load(text)


@pytest.mark.parametrize("overrides", [
    [],
    ["preset=fast_e2e"],
    ["dataset=synthetic_room", "model.voxel_size=0.02",
     "dataset.img_res=[480,640]", "model.max_unique_per_frame=116736"],
])
def test_composition_matches_jax(overrides):
    assert load_config(overrides).to_dict() == \
        jload_config(overrides).to_dict()
