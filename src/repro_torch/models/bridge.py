"""Weight bridge: the reference's parameter tree (as numpy) -> the port's.

The reference (``repro.models.network.init``) returns nested dicts and
tuples of arrays with the scan-stacked leading layer dim on every block
leaf; the port keeps that tree, so the bridge is a checked leaf-by-leaf
copy.  Every leaf the port defines must be present with the defined
shape, and every leaf of the given tree must be consumed: anything left
unmapped raises.  hubert's frames frontend crosses the same way: its
``frame_proj`` and untied ``lm_head`` in place of ``embed``.  A tree the reference has already quantized
(``repro.quant.serving_quant_params``, its QuantTensor leaves holding
numpy ``q``/``scale``) crosses as the port's QuantTensors, bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import network as N
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.quant.policy import QuantTensor


def _leaf_paths(tree: Any, path: tuple = ()) -> set[tuple]:
    if isinstance(tree, dict):
        return set().union(*(_leaf_paths(v, path + (k,))
                             for k, v in tree.items())) if tree else set()
    if isinstance(tree, (tuple, list)):
        return set().union(*(_leaf_paths(v, path + (i,))
                             for i, v in enumerate(tree))) if tree else set()
    return {path}


def _lookup(tree: Any, path: tuple) -> Any:
    for key in path:
        try:
            tree = tree[key]
        except (KeyError, IndexError, TypeError):
            raise KeyError(f"reference tree has no leaf at {path}") from None
    return tree


def from_jax_params(tree: Any, cfg: ModelConfig,
                    device: str | torch.device | None = None) -> Any:
    """Convert the reference's parameter tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) into the port's parameters on
    ``device``, in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    defs = N.param_defs(cfg)
    extra = _leaf_paths(tree) - _leaf_paths(defs)
    if extra:
        raise KeyError(f"reference leaves with no port counterpart: "
                       f"{sorted(map(str, extra))}")

    def convert(path, d):
        leaf = _lookup(tree, path)
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):   # QuantTensor
            q = np.asarray(leaf.q)
            sc = np.asarray(leaf.scale, dtype=np.float32)
            if q.dtype != np.int8 or q.shape != d.shape \
                    or sc.shape != d.shape[:-2] + d.shape[-1:]:
                raise ValueError(f"quantized leaf {path}: q {q.dtype} "
                                 f"{q.shape}, scale {sc.shape}; port "
                                 f"expects int8 {d.shape}")
            return QuantTensor(torch.from_numpy(q.copy()).to(dev),
                               torch.from_numpy(sc.copy()).to(dev))
        arr = np.array(leaf, dtype=np.float32)
        if arr.shape != d.shape:
            raise ValueError(f"leaf {path}: reference shape {arr.shape}, "
                             f"port expects {d.shape}")
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return tree_map(convert, defs)
