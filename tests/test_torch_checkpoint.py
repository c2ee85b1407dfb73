"""Port parity: the reader of the reference's Lightning ``.ckpt`` files.

The reference checkpoints are not in the repository, so each test builds a
synthetic one with ``torch.save`` in the reference's layout: the tcnn
format with its exact blob sizes (10240 and 11264 floats) and the non-tcnn
format with BatchNorm statistics that are far from the identity.  Each
also pickles an object of a class that ``torch.load(weights_only=True)``
refuses, as Lightning callbacks and omegaconf nodes are, plus a bfloat16
tensor.  Exact: the port's reader and the JAX package's give identical
arrays, and both equal what ``torch.load`` itself returns.
"""

import collections
import pickle

import numpy as np
import pytest
import torch

from bnv_fusion_tpu import checkpoint as jckpt
from bnv_fusion_tpu_torch import checkpoint as tckpt
from bnv_fusion_tpu_torch import run_e2e
from bnv_fusion_tpu_torch.config import load_config


class _LightningCallbackState:
    """Stands in for the callback objects a Lightning checkpoint pickles."""

    def __init__(self):
        self.monitor = "val_loss"
        self.best = np.float32(0.25)


def _common(rng):
    return {"epoch": 7, "global_step": 1234,
            "callbacks": {"ModelCheckpoint": _LightningCallbackState()},
            "ema": torch.tensor(rng.randn(4, 3), dtype=torch.bfloat16)}


def _tcnn_ckpt(path, rng):
    sd = collections.OrderedDict([
        ("pointnet_backbone.model.params",
         torch.tensor(rng.randn(10240).astype(np.float32) * 0.1)),
        ("nerf.model.params",
         torch.tensor(rng.randn(11264).astype(np.float32) * 0.1)),
    ])
    torch.save({"state_dict": sd, **_common(rng)}, path)


def _torch_ckpt(path, rng, hid=32):
    sd = collections.OrderedDict()
    dims = [6, hid, hid, hid, 8]
    for i in range(1, 5):
        o, n = dims[i], dims[i - 1]
        sd[f"pointnet_backbone.conv{i}.weight"] = torch.tensor(
            rng.randn(o, n, 1).astype(np.float32))
        sd[f"pointnet_backbone.conv{i}.bias"] = torch.tensor(
            rng.randn(o).astype(np.float32))
        sd[f"pointnet_backbone.bn{i}.weight"] = torch.tensor(
            rng.uniform(0.5, 2.0, o).astype(np.float32))
        sd[f"pointnet_backbone.bn{i}.bias"] = torch.tensor(
            rng.randn(o).astype(np.float32))
        sd[f"pointnet_backbone.bn{i}.running_mean"] = torch.tensor(
            rng.randn(o).astype(np.float32))
        sd[f"pointnet_backbone.bn{i}.running_var"] = torch.tensor(
            rng.uniform(0.1, 3.0, o).astype(np.float32))
        sd[f"pointnet_backbone.bn{i}.num_batches_tracked"] = torch.tensor(
            1000, dtype=torch.int64)
    ddims = [17, hid, hid, hid, hid]
    for i in range(4):
        sd[f"nerf.geo_layer{i}.weight"] = torch.tensor(
            rng.randn(ddims[i + 1], ddims[i]).astype(np.float32))
        sd[f"nerf.geo_layer{i}.bias"] = torch.tensor(
            rng.randn(ddims[i + 1]).astype(np.float32))
    sd["nerf.fc_alpha.weight"] = torch.tensor(
        rng.randn(1, hid).astype(np.float32))
    sd["nerf.fc_alpha.bias"] = torch.tensor(rng.randn(1).astype(np.float32))
    torch.save({"state_dict": sd, **_common(rng)}, path)


@pytest.fixture(params=["tcnn", "torch"])
def ckpt_path(request, tmp_path):
    path = str(tmp_path / f"pointnet_{request.param}.ckpt")
    rng = np.random.RandomState(0 if request.param == "tcnn" else 1)
    (_tcnn_ckpt if request.param == "tcnn" else _torch_ckpt)(path, rng)
    return path


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reader_matches_jax_and_torch_load(ckpt_path):
    with pytest.raises(pickle.UnpicklingError):
        torch.load(ckpt_path, weights_only=True)
    ours = tckpt.load_torch_checkpoint(ckpt_path)
    theirs = jckpt.load_torch_checkpoint(ckpt_path)
    ref = torch.load(ckpt_path, weights_only=False)
    assert ours["epoch"] == ref["epoch"] and \
        ours["global_step"] == ref["global_step"]
    assert type(ours["callbacks"]["ModelCheckpoint"]).__name__ == \
        "_LightningCallbackState"
    for name, t in list(ref["state_dict"].items()) + [("ema", ref["ema"])]:
        got = ours["state_dict"][name] if name != "ema" else ours["ema"]
        want = theirs["state_dict"][name] if name != "ema" else theirs["ema"]
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            got, t.to(torch.float32).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), err_msg=name)


def test_load_pretrained_matches_jax(ckpt_path):
    ours = tckpt.load_pretrained(ckpt_path)
    _assert_trees_equal(ours, jckpt.load_pretrained(ckpt_path))
    enc, dec = ours["encoder"], ours["decoder"]
    assert enc["w0"].shape[0] == 6 and enc["w_out"].shape[1] == 8
    assert dec["w0"].shape[0] == 17 and dec["w_out"].shape[1] == 1
    if "tcnn" in ckpt_path:
        assert enc["w0"].shape == (6, 64) and dec["w0"].shape == (17, 64)
    else:
        # folded BatchNorm: y = bn(conv(x)) for a random input
        sd = torch.load(ckpt_path, weights_only=False)["state_dict"]
        x = torch.randn(5, 6)
        conv = torch.nn.functional.linear(
            x, sd["pointnet_backbone.conv1.weight"][..., 0],
            sd["pointnet_backbone.conv1.bias"])
        bn = torch.nn.functional.batch_norm(
            conv, sd["pointnet_backbone.bn1.running_mean"],
            sd["pointnet_backbone.bn1.running_var"],
            sd["pointnet_backbone.bn1.weight"],
            sd["pointnet_backbone.bn1.bias"], training=False, eps=1e-5)
        folded = x @ torch.as_tensor(enc["w0"]) + torch.as_tensor(enc["b0"])
        torch.testing.assert_close(folded, bn, atol=1e-4, rtol=1e-5)


def test_run_e2e_load_params_reads_ckpt(ckpt_path):
    cfg = load_config([f"trainer.checkpoint={ckpt_path}"])
    _assert_trees_equal(run_e2e.load_params(cfg),
                        jckpt.load_pretrained(ckpt_path))
