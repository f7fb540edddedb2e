"""Parameter dumps as flat `.npz` files, the JAX package's `tools.py` format.

A nested dict (or list) of arrays is stored with `/`-joined keys, one array
per leaf; lists come back as dicts keyed by their indices. np.savez has no
format code for bfloat16, so a bf16 leaf is stored as raw 2-byte void ('V2')
and read back with a view through int16 into torch.bfloat16 (the JAX package
views the same bytes as ml_dtypes.bfloat16). A file written by either package
reads in the other.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def export_params_npz(params, path: str) -> None:
    """Save a nested dict / list of tensors or arrays as a flat .npz."""
    flat: Dict[str, np.ndarray] = {}

    def visit(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                visit(f"{prefix}/{i}", v)
        else:
            flat[prefix] = _to_numpy(tree)

    visit("", params)
    np.savez(path, **flat)


def import_params_npz(path: str) -> Dict[str, Any]:
    """Inverse of export_params_npz: a nested dict of CPU tensors (lists come
    back as dicts of indices), bf16 leaves as torch.bfloat16."""
    root: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            arr = flat[key]
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr))
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return root
