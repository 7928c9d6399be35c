"""Load the JAX package's parameters into the port's ``Model``.

``params_from_jax`` takes the JAX param pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), with the layer leaves
stacked on a leading (L, ...) axis, and returns a ``Model`` holding the
same values: bf16 arrays are reinterpreted bit for bit.  With ``fsdp``
> 1 the model shards its layer parameters over ``rt.fsdp_group`` and
this rank keeps its slice of each global array (``Model.set_params``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
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
              for k, v in np_tree.items() if k != "layers"}
    params["layers"] = [_map(np_tree["layers"], lambda a, i=i: to_tensor(a[i], dev))
                        for i in range(cfg.n_layers)]
    return model.set_params(params)
