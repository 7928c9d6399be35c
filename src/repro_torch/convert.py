"""Load the JAX package's parameters into the port's ``Model``.

``params_from_jax`` takes the JAX param pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), global as the reference
draws them for the TP size of ``rt``, with the layer leaves stacked on a
leading (L, ...) axis (an encoder-decoder's ``enc_layers`` too), and
returns a ``Model`` holding the same values:
bf16 arrays are reinterpreted bit for bit.  Each rank keeps its slice of
every global array (``Model.set_params``): its TP shard over
``rt.tp_group`` and, with ``fsdp`` > 1, its FSDP shard of that over
``rt.fsdp_group``, the reference's addressable shard of the array under
``NamedSharding(mesh, model.param_specs(...))``; an MoE layer's expert banks
split on the expert dim under ``ep`` and on d_ff under ``etp``, and its f32
router stays whole.  Where the heads pad at the TP size, the tree
holds them at the padded shapes (the reference's ``init`` at that TP
size); elsewhere ``models.model.pad_vocab`` turns a tree drawn at TP 1
into the tree of a larger TP size that computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import STACKED, Model
from repro_torch.parallel.sharding import Runtime


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree: dict, cfg: ModelConfig, rt: Runtime | None = None,
                    device="cuda", fsdp: int = 1) -> Model:
    model = Model(cfg, rt, device).with_fsdp(fsdp)
    dev = model.init_device
    params = {k: _map(v, lambda a: to_tensor(a, dev))
              for k, v in np_tree.items() if k not in STACKED}
    for key, n in (("layers", cfg.n_layers), ("enc_layers", cfg.n_enc_layers)):
        if key in np_tree:
            params[key] = [_map(np_tree[key], lambda a, i=i: to_tensor(a[i], dev))
                           for i in range(n)]
    return model.set_params(params)
