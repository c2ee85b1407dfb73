"""Checkpoint IO: the reference's pretrained ``.ckpt`` files and our own npz.

Counterpart of bnv_fusion_tpu/checkpoint.py:51-249.  The reader parses the
zip+pickle torch serialization with numpy alone (no ``torch.load``): a
PyTorch-Lightning checkpoint pickles callback and omegaconf objects, which
``torch.load(weights_only=True)`` refuses and which need not be importable
here, so unknown classes become inert stubs and tensors come back as numpy
arrays.  The converters turn both reference architectures into the
``{"encoder": ..., "decoder": ...}`` dict of numpy arrays that
``nn.params_from_numpy`` moves onto a device; the JAX package's reader gives
the same arrays.

tcnn parameter packing (validated by the exact blob sizes): tiny-cuda-nn's
FullyFusedMLP(n_neurons=64, n_hidden_layers=3) behind an Identity encoding
stores one flat fp32 vector of row-major ``[n_out, n_in]`` weight matrices
(no biases), with the input width padded to a multiple of 16 (the padded
input lanes carry a constant 1.0) and the output width padded to a multiple
of 16 (extra rows unused):

* ``pointnet_backbone.model.params`` (10240) = 64x16 + 64x64 + 64x64 + 16x64
* ``nerf.model.params``             (11264) = 64x32 + 64x64 + 64x64 + 16x64

The npz state format (keys are "/"-joined paths) is the JAX package's, so
the two packages read each other's files.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict

import numpy as np

_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": None,  # handled specially (upcast to float32)
}


class _ODict(dict):
    """Stand-in for collections.OrderedDict in pickled payloads."""


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a torch-serialized (zipfile) checkpoint into plain numpy arrays.

    Unknown classes (Lightning callbacks, omegaconf nodes, ...) are replaced
    with inert stubs; tensors come back as numpy arrays.
    """
    zf = zipfile.ZipFile(path)
    prefix = zf.namelist()[0].split("/")[0]

    def rebuild_tensor(storage, offset, size, stride, *unused):
        arr, dt = storage
        if dt is None:  # bfloat16 -> float32
            arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        if not size:
            return np.array(arr[offset])
        view = np.lib.stride_tricks.as_strided(
            arr[offset:], shape=tuple(size),
            strides=[s * arr.itemsize for s in stride])
        return np.array(view)

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch._utils" and name.startswith("_rebuild_tensor"):
                return rebuild_tensor
            if name == "OrderedDict":
                return _ODict
            if module == "torch" and name.endswith("Storage"):
                return ("storage", name)

            class Stub:
                def __init__(self, *a, **k):
                    pass

                def __setstate__(self, state):
                    self._state = state

                def __call__(self, *a, **k):
                    return self

            Stub.__name__ = name
            return Stub

        def persistent_load(self, pid):
            _, storage_type, key, _device, _numel = pid
            name = (storage_type[1] if isinstance(storage_type, tuple)
                    else "FloatStorage")
            dt = _STORAGE_DTYPES.get(name, np.float32)
            data = zf.read(f"{prefix}/data/{key}")
            arr = np.frombuffer(data, dtype=np.uint16 if dt is None else dt)
            return (arr, dt)

    return Unpickler(io.BytesIO(zf.read(f"{prefix}/data.pkl"))).load()


def _fold_batchnorm(w: np.ndarray, b: np.ndarray, bn: Dict[str, np.ndarray],
                    eps: float = 1e-5):
    """Fold an eval-mode BatchNorm1d into the preceding 1x1 conv:
    y = gamma * (Wx + b - mean) / sqrt(var + eps) + beta."""
    gamma, beta = bn["weight"], bn["bias"]
    mean, var = bn["running_mean"], bn["running_var"]
    scale = gamma / np.sqrt(var + eps)
    w_f = w * scale[:, None]
    b_f = (b - mean) * scale + beta
    return w_f.astype(np.float32), b_f.astype(np.float32)


def convert_pointnet_torch(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Convert the non-tcnn checkpoint (pretrained/pointnet.ckpt): four 1x1
    Conv1d + BatchNorm encoder layers, each pair folded into one dense
    layer; decoder geo_layer0..3 + fc_alpha.  Layers are stored ``w``
    [in, out] and ``b`` [out]."""
    sd = state_dict
    enc = {}
    for i in range(1, 5):
        w = sd[f"pointnet_backbone.conv{i}.weight"][..., 0]  # [out, in]
        b = sd[f"pointnet_backbone.conv{i}.bias"]
        bn = {k: sd[f"pointnet_backbone.bn{i}.{k}"]
              for k in ("weight", "bias", "running_mean", "running_var")}
        w_f, b_f = _fold_batchnorm(w, b, bn)
        wname = "w_out" if i == 4 else f"w{i - 1}"
        bname = "b_out" if i == 4 else f"b{i - 1}"
        enc[wname] = w_f.T.copy()
        enc[bname] = b_f

    dec = {}
    for i in range(4):  # geo_layer0..3 all have ReLU -> all are "hidden"
        dec[f"w{i}"] = sd[f"nerf.geo_layer{i}.weight"].T.copy().astype(np.float32)
        dec[f"b{i}"] = sd[f"nerf.geo_layer{i}.bias"].astype(np.float32)
    dec["w_out"] = sd["nerf.fc_alpha.weight"].T.copy().astype(np.float32)
    dec["b_out"] = sd["nerf.fc_alpha.bias"].astype(np.float32)
    return {"encoder": enc, "decoder": dec}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def unpack_tcnn_mlp(params: np.ndarray, n_in: int, n_out: int,
                    width: int = 64, n_hidden: int = 3) -> Dict[str, np.ndarray]:
    """De-flatten a tcnn FullyFusedMLP params blob into per-layer matrices
    ``w`` [in, out].  The padded input lanes receive a constant 1.0, so the
    first layer's padding columns, summed, become its bias."""
    in_pad = _round_up(n_in, 16)
    out_pad = _round_up(n_out, 16)
    sizes = [(width, in_pad)] + [(width, width)] * (n_hidden - 1) + \
        [(out_pad, width)]
    expected = sum(o * i for o, i in sizes)
    if params.size != expected:
        raise ValueError(
            f"tcnn blob size {params.size} != expected {expected} "
            f"for MLP {n_in}->{width}x{n_hidden}->{n_out}")
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for li, (o, i) in enumerate(sizes):
        mat = params[offset:offset + o * i].reshape(o, i).astype(np.float32)
        offset += o * i
        if li == 0:
            out["w0"] = mat[:, :n_in].T.copy()
            out["b0"] = mat[:, n_in:].sum(axis=1)
        elif li == len(sizes) - 1:
            out["w_out"] = mat[:n_out, :].T.copy()
            out["b_out"] = np.zeros((n_out,), np.float32)
        else:
            out[f"w{li}"] = mat.T.copy()
            out[f"b{li}"] = np.zeros((o,), np.float32)
    return out


def convert_pointnet_tcnn(state_dict: Dict[str, np.ndarray],
                          feat_dims: int = 8) -> Dict[str, Any]:
    """Convert pretrained/pointnet_tcnn.ckpt (the default e2e checkpoint):
    encoder 6 -> 64x3 -> feat_dims, decoder (9 PE + feat_dims) -> 64x3 -> 1."""
    enc = unpack_tcnn_mlp(state_dict["pointnet_backbone.model.params"],
                          n_in=6, n_out=feat_dims)
    pe_dims = 3 + 2 * 3 * 1  # include_input + 1 frequency
    dec = unpack_tcnn_mlp(state_dict["nerf.model.params"],
                          n_in=pe_dims + feat_dims, n_out=1)
    return {"encoder": enc, "decoder": dec}


def load_pretrained(path: str) -> Dict[str, Any]:
    """Load either reference checkpoint format, auto-detected by its keys."""
    ck = load_torch_checkpoint(path)
    sd = ck["state_dict"] if "state_dict" in ck else ck
    if "pointnet_backbone.model.params" in sd:
        return convert_pointnet_tcnn(sd)
    return convert_pointnet_torch(sd)


def save_state(path: str, tree: Dict[str, Any]) -> None:
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", tree)
    np.savez_compressed(path, **flat)


def load_state(path: str) -> Dict[str, Any]:
    data = np.load(path, allow_pickle=False)
    tree: Dict[str, Any] = {}
    for key in data.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree
