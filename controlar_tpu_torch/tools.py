"""Checkpoint and zoo utilities (the JAX package's `tools.py`; the
reference's tools/): parameter dumps as flat `.npz` files, Lightning
checkpoint conversion, the code-tree check and the hub folder.

A nested dict (or list) of arrays is stored with `/`-joined keys, one array
per leaf; lists come back as dicts keyed by their indices. np.savez has no
format code for bfloat16, so a bf16 leaf is stored as raw 2-byte void ('V2')
and read back with a view through int16 into torch.bfloat16 (the JAX package
views the same bytes as ml_dtypes.bfloat16). A file written by either package
reads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _flatten(params) -> Dict[str, Any]:
    """A nested dict / list -> {`/`-joined key: leaf}."""
    flat: Dict[str, Any] = {}

    def visit(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                visit(f"{prefix}/{i}", v)
        else:
            flat[prefix] = tree

    visit("", params)
    return flat


def export_params_npz(params, path: str) -> None:
    """Save a nested dict / list of tensors or arrays as a flat .npz."""
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(params).items()})


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


def convert_lightning_checkpoint(src: str, dst: str) -> None:
    """A PyTorch-Lightning checkpoint -> a plain {"model": state_dict} .pt
    (the reference's tools/convert_pytorch_lightning_to_torch.py). The
    Lightning file holds more than tensors, so it is unpickled in full, as
    the JAX package's tool does: run it on files you trust."""
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    torch.save({"model": sd}, dst)


def check_code_tree(tree_dir: str, expected_len: Optional[int] = None) -> Dict:
    """Sanity-check an extracted code tree (the reference's
    tools/check_image_codes.py): counts, contiguity of indices, token-range
    stats over a sample of the codes."""
    code_dir = os.path.join(tree_dir, "code")
    files = set(os.listdir(code_dir))
    n = len(files)
    missing = [i for i in range(n) if f"{i}.npy" not in files]
    mn, mx = 1 << 30, -1
    for i in range(0, n, max(n // 64, 1)):
        if f"{i}.npy" in files:
            arr = np.load(os.path.join(code_dir, f"{i}.npy"))
            mn, mx = min(mn, int(arr.min())), max(mx, int(arr.max()))
    report = {"count": n, "missing": missing, "token_min": mn, "token_max": mx}
    if expected_len is not None:
        report["complete"] = n == expected_len and not missing
    return report


def save_hub_folder(params, config_dict: Dict, out_dir: str,
                    model_card: Optional[str] = None) -> str:
    """Write a hub-layout folder: params.safetensors (flat `/`-joined keys),
    config.json and README.md, the layout the JAX package's
    `save_hub_folder` writes and its `load_hub_folder` reads (either
    package reads the other's). params: a nested dict / list of tensors or
    arrays. Returns the folder; `push_to_hub` uploads it."""
    from controlar_tpu_torch.checkpoint import save_safetensors

    os.makedirs(out_dir, exist_ok=True)
    flat = {k: v.detach().cpu() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)) for k, v in _flatten(params).items()}
    save_safetensors(flat, os.path.join(out_dir, "params.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_dict, f, indent=1)
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(model_card or "# controlar_tpu_torch checkpoint\n")
    return out_dir


def load_hub_folder(out_dir: str):
    """Inverse of save_hub_folder: (params tree of CPU tensors, config dict);
    dicts whose keys are all digits come back as lists."""
    from controlar_tpu_torch.checkpoint import load_safetensors

    tree: Dict[str, Any] = {}
    for key, val in load_safetensors(os.path.join(out_dir, "params.safetensors")).items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    with open(os.path.join(out_dir, "config.json")) as f:
        config = json.load(f)
    return listify(tree), config


def push_to_hub(folder: str, repo_id: str, token: Optional[str] = None) -> str:
    """Upload a save_hub_folder() folder to the Hugging Face hub (needs the
    network and credentials; the folder itself is the offline artifact)."""
    from huggingface_hub import HfApi

    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=folder, repo_id=repo_id)
    return f"https://huggingface.co/{repo_id}"
