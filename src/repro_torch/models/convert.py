"""Reference (JAX) parameter trees -> the port's params.

``params_from_jax(tree)`` takes the reference's params pytree with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) -- nested
dicts, decoder layers stacked on axis 0 as the reference's scan keeps
them -- and returns the same tree of torch tensors.  Layouts are kept
(``wq`` (d, heads, head_dim), ``wo`` (heads, head_dim, d), ...), so the
port's einsums are the reference's.

The port stores float32 masters and casts them to bf16 per call, as the
reference does (``params["wq"].astype(x.dtype)``); norm weights stay
float32 inside the norms.  Storing bf16 copies instead would round each
product weight once to bf16 as well and compute the same thing, at half
the memory; the masters keep the tree identical to the reference's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any) -> Any:
    """The reference's params tree as CPU torch tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))
