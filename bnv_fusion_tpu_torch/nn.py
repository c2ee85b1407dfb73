"""Neural nets: PointNet local-shape encoder and the tiny SDF decoder MLP.

Counterpart of bnv_fusion_tpu/nn.py:31-133.  Parameters are plain dicts of
``w``/``b`` tensors (``w`` stored [in, out]), the same layout as the JAX
package's pytrees, so ``params_from_numpy`` moves weights between the two
packages unchanged.  ``compute_dtype=torch.bfloat16`` (the fuse path's
``model.fuse_dtype``, and the optimize loss's ``model.optim_dtype``)
rounds every matmul operand to bfloat16 and multiplies in float32, as the
JAX package's bf16 products with float32 accumulation do; torch's own bf16
matmul would round the product as well.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and held in float32 (a no-op for float32)."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply a ReLU MLP stored as {w0,b0,...,w_out,b_out} (no final ReLU);
    operands rounded to ``compute_dtype``, products and biases in f32."""
    n_hidden = sum(1 for k in params if k.startswith("w") and k != "w_out")
    h = round_to(x, compute_dtype)
    for i in range(n_hidden):
        h = torch.relu(h @ round_to(params[f"w{i}"], compute_dtype)
                       + params[f"b{i}"])
        h = round_to(h, compute_dtype)
    return h @ round_to(params["w_out"], compute_dtype) + params["b_out"]


def positional_encoding(x: torch.Tensor, num_fns: int = 1,
                        include_input: bool = True,
                        log_sampling: bool = True) -> torch.Tensor:
    """NeRF sin/cos encoding: with num_fns=1 a 3-vector maps to 9 dims
    [x, sin(x), cos(x)]."""
    outs = [x] if include_input else []
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, num_fns - 1, num_fns)
    else:
        freqs = np.linspace(2.0 ** 0.0, 2.0 ** (num_fns - 1), num_fns)
    for f in freqs:
        outs.append(torch.sin(x * float(f)))
        outs.append(torch.cos(x * float(f)))
    return torch.cat(outs, dim=-1)


def encoder_apply(params: Dict[str, Any], pts6: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PointNet per-point features: [..., 6] -> [..., feat_dims].

    The first three channels are the point's offset from the voxel corner in
    voxel units, the last three the world-frame unit normal."""
    return mlp_apply(params["encoder"], pts6, compute_dtype)


def encoder_global_apply(params: Dict[str, Any], pts6: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-pooled global feature over a point set: [B, N, 6] -> [B, F],
    over the ``valid`` points only when a mask is given."""
    feats = mlp_apply(params["encoder"], pts6)
    if valid is None:
        return torch.mean(feats, dim=-2)
    v = valid[..., None].to(feats.dtype)
    return torch.sum(feats * v, dim=-2) / torch.clamp(torch.sum(v, dim=-2),
                                                      min=1.0)


def decoder_apply(params: Dict[str, Any], local_xyz: torch.Tensor,
                  feats: torch.Tensor, num_pe_fns: int = 1,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SDF decoder: (local offset in voxel units, latent) -> raw SDF [..., 1],
    operands rounded to ``compute_dtype`` as in ``mlp_apply``.

    The raw output is normalized; callers multiply by voxel_size."""
    pe = positional_encoding(local_xyz, num_fns=num_pe_fns)
    return mlp_apply(params["decoder"], torch.cat([pe, feats.to(pe.dtype)], -1),
                     compute_dtype)


def _init_mlp(rs: np.random.RandomState, dims,
              bias_std: float) -> Dict[str, np.ndarray]:
    params = {}
    n = len(dims) - 1
    for i in range(n):
        s = float(np.sqrt(2.0 / dims[i]))
        name, bname = (f"w{i}", f"b{i}") if i < n - 1 else ("w_out", "b_out")
        params[name] = (rs.standard_normal((dims[i], dims[i + 1])) * s
                        ).astype(np.float32)
        params[bname] = np.zeros((dims[i + 1],), np.float32)
    if bias_std > 0:     # no draws at 0, so zero-bias weights keep their bits
        for k in params:
            if k.startswith("b"):
                params[k] = (rs.standard_normal(params[k].shape) * bias_std
                             ).astype(np.float32)
    return params


def init_model(seed: int = 0, feat_dims: int = 8, hidden: int = 64,
               n_hidden: int = 3, num_pe_fns: int = 1,
               device: torch.device | str = "cpu",
               bias_std: float = 0.0) -> Dict[str, Any]:
    """Fresh (untrained) encoder+decoder params with the tcnn-sized topology.

    He-normal weights and zero biases, the shapes and distributions of the
    JAX package's init_model, drawn from ``numpy.random.RandomState(seed)``
    (the bits differ from JAX's PRNG).  ``bias_std > 0`` draws the biases
    from N(0, bias_std^2) instead, so that checks of the decode see biases
    as trained weights have them."""
    rs = np.random.RandomState(seed)
    pe_dims = 3 + 2 * 3 * num_pe_fns
    tree = {
        "encoder": _init_mlp(rs, [6] + [hidden] * n_hidden + [feat_dims],
                             bias_std),
        "decoder": _init_mlp(rs, [pe_dims + feat_dims] + [hidden] * n_hidden
                             + [1], bias_std),
    }
    return params_from_numpy(tree, device)


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Nested dict of numpy arrays (e.g. the JAX parameter pytree after
    ``jax.tree.map(np.asarray, ...)``) -> the same dict of float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)
