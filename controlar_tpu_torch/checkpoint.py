"""Checkpoints: the port's training state, and the loaders of released and
native weights (the JAX package's `checkpoint.py`).

Training state is saved with `torch.save`, one `step_XXXXXXXX` directory
per checkpoint, as the JAX package names them. A checkpoint holds the step,
the fp32 parameters, the optimizer's count and moments and the EMA;
restoring it into a state built the same way continues the run bit for bit.

Weights load from:
- the reference's `.pt` / `.pth` (a state dict, or one under "model",
  "module" or "state_dict"), read with `torch.load(weights_only=True)`;
  argparse.Namespace, which the reference saves as "args" beside the
  model, is allowed; any other object (which unpickling could run code
  for) is refused;
- `.safetensors`, through the reader below (the 8-byte header length, the
  JSON header, the raw buffer), so no `safetensors` package is needed;
- native checkpoints: the JAX package's `.npz` dumps (`tools.py`) and the
  port's own step directories, or a results directory holding them (the
  latest step wins). The JAX package's orbax directories cannot be read
  without orbax; they raise an error that names the format.
`load_gpt_checkpoint`, `load_vq_checkpoint`, `load_adapter_checkpoint` and
`load_t5_encoder` return the port's module on the asked device and dtype.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from controlar_tpu_torch import convert, convert_ref, resolve_device, tools
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import t5 as t5_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.train.optimizer import AdamState
from controlar_tpu_torch.train.step import TrainState

_FILE = "state.pt"


def _save(ckpt_dir: str, step: int, tree: Dict[str, Any]) -> str:
    """torch.save the tree as ckpt_dir/step_XXXXXXXX/state.pt; -> the directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    torch.save(tree, os.path.join(path, _FILE))
    return path


def save_train_state(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save the state under ckpt_dir/step_XXXXXXXX; returns that path."""
    opt = state.opt_state
    return _save(ckpt_dir, state.step if step is None else step, {
        "step": state.step,
        "params": {n: p.detach() for n, p in state.params.items()},
        "opt_count": opt.count, "mu": opt.mu, "nu": opt.nu,
        "ema_params": state.ema_params,
    })


def save_vq_train_state(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Save a `train.vq_step.VQTrainState` under ckpt_dir/step_XXXXXXXX, its
    parameters under "vq_params", "disc_params" and "ema_params" (None
    without an EMA), as the JAX package's VQ training state names them;
    `load_vq_checkpoint` reads the EMA first. Returns the path."""

    def opt(o: AdamState):
        return {"count": o.count, "mu": o.mu, "nu": o.nu}

    return _save(ckpt_dir, state.step if step is None else step, {
        "step": state.step,
        "vq_params": {n: p.detach() for n, p in state.vq_params.items()},
        "disc_params": {n: p.detach() for n, p in state.disc_params.items()},
        "ema_params": state.ema_params,
        "vq_opt": opt(state.vq_opt), "disc_opt": opt(state.disc_opt),
    })


@torch.no_grad()
def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a state of the same structure: the parameters
    are copied into the state's tensors (the modules' own), the moments and
    EMA moved to their devices and dtypes."""
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if set(saved["params"]) != set(state.params):
        raise ValueError(f"{path}: parameters differ from the state's")
    for n, p in state.params.items():
        p.copy_(saved["params"][n])

    def like(src, ref):
        return {n: src[n].to(device=t.device, dtype=t.dtype) for n, t in ref.items()}

    opt = state.opt_state
    ema = None
    if state.ema_params is not None:
        ema = like(saved["ema_params"], state.ema_params)
    return TrainState(saved["step"], state.params,
                      AdamState(saved["opt_count"], like(saved["mu"], opt.mu),
                                like(saved["nu"], opt.nu)), ema)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


# ---------------------------------------------------------------------------
# Files: .pt / .pth and .safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str, keep: Optional[Callable[[str], bool]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor} in the file's dtypes; with
    `keep`, only the tensors whose names it accepts, reading only their
    bytes (a seq2seq checkpoint's decoder is never read)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        for name, info in header.items():
            if name == "__metadata__" or (keep is not None and not keep(name)):
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                                 f"does not take ({sorted(_ST_DTYPES)})")
            dtype, shape = _ST_DTYPES[info["dtype"]], info["shape"]
            begin, end = info["data_offsets"]
            count = int(np.prod(shape, dtype=np.int64))
            if (not 0 <= begin <= end <= size
                    or end - begin != count * torch.empty((), dtype=dtype).element_size()):
                raise ValueError(f"{path}: {name} has bytes [{begin}, {end}) of {size} for "
                                 f"shape {shape}")
            f.seek(8 + n + begin)
            buf = bytearray(f.read(end - begin))
            t = (torch.frombuffer(buf, dtype=dtype, count=count) if count
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(shape)
    return out


def save_safetensors(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as .safetensors (the header padded with spaces to
    8 bytes, tensors in the given order); any reader of the format takes it."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name, t in sd.items():
        t = t.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def unwrap_state_dict(ckpt: Mapping) -> Mapping:
    """The reference's checkpoint containers: the state dict under "model",
    "module" or "state_dict", else the mapping itself."""
    for key in ("model", "module", "state_dict"):
        if key in ckpt and isinstance(ckpt[key], Mapping):
            return ckpt[key]
    return ckpt


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pt / .pth or .safetensors file -> a flat state dict of CPU tensors
    (the reference's wrappers removed)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = unwrap_state_dict(ckpt) if isinstance(ckpt, Mapping) else ckpt
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

def _step_dir(path: str) -> str:
    """A step_XXXXXXXX directory, or the latest one in a results directory
    (or its `checkpoints`)."""
    p = os.path.abspath(path)
    if not os.path.basename(p).startswith("step_"):
        sub = os.path.join(p, "checkpoints")
        if os.path.isdir(sub):
            p = sub
        latest = latest_checkpoint(p)
        if latest:
            p = latest
    return p


def load_native_checkpoint(path: str) -> Dict[str, Any]:
    """A .npz parameter dump (either package's `export_params_npz`: the
    nested tree of tensors), or the port's training checkpoint (a
    step_XXXXXXXX directory, or a results directory holding them; the
    latest step wins): its saved dict {step, params, ..., ema_params}."""
    if path.endswith(".npz"):
        return tools.import_params_npz(path)
    p = _step_dir(path)
    f = os.path.join(p, _FILE)
    if not os.path.isfile(f):
        raise ValueError(
            f"{p} holds no {_FILE}: an orbax checkpoint directory of the JAX package cannot be "
            "read without orbax; export its parameters with the JAX package's "
            "tools.export_params_npz and load the .npz")
    return torch.load(f, map_location="cpu", weights_only=True)


def _is_native(path: str) -> bool:
    return path.endswith(".npz") or os.path.isdir(path)


def _is_flat(tree: Mapping) -> bool:
    """The port's flat state dict (dotted names), not the JAX package's tree."""
    return all(isinstance(v, torch.Tensor) for v in tree.values())


def _strip(tree: Mapping, prefix: str) -> Dict[str, Any]:
    if _is_flat(tree) and any(k.startswith(prefix) for k in tree):
        return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}
    return dict(tree)


def native_params(tree: Mapping, module: str) -> Dict[str, Any]:
    """A module's parameters in a native checkpoint: the EMA when there is
    one, else the params, else the tree itself; under `module` (the JAX
    package's control state) or `module.` (the port's `ControlModel`) when
    present."""
    params = tree.get("ema_params") or tree.get("params") or tree
    if module in params and isinstance(params[module], Mapping):
        return params[module]
    return _strip(params, module + ".")


def native_gpt_params(tree: Mapping) -> Dict[str, Any]:
    """The GPT's parameters of a native checkpoint (`native_params`)."""
    return native_params(tree, "gpt")


def load_gpt_checkpoint(path: str, cfg, dtype: torch.dtype = torch.float32, device="cuda",
                        fill_from: Optional[gpt_model.GPT] = None) -> gpt_model.GPT:
    """GPT weights -> the port's GPT on `device` in `dtype`: a reference
    .pt / .safetensors (`convert_ref.gpt_from_state_dict`; a base LlamaGen
    checkpoint's control modules from `fill_from`, else from
    `init_gpt(cfg, 0)`), a JAX .npz dump (`convert.gpt_from_jax`) or a port
    step directory."""
    device = resolve_device(device)
    if not _is_native(path):
        return convert_ref.gpt_from_state_dict(load_torch_file(path), cfg, dtype, device,
                                               fill_from)
    params = native_gpt_params(load_native_checkpoint(path))
    if _is_flat(params):
        return convert._build(lambda: gpt_model.GPT(cfg), params, dtype, device)
    return convert.gpt_from_jax(params, cfg, dtype, device)


def load_vq_checkpoint(path: str, cfg, dtype: torch.dtype = torch.float32,
                       device="cuda") -> vq_model.VQModel:
    """VQ weights, encoder included -> the port's VQModel: a reference .pt /
    .safetensors, a JAX .npz dump (the EMA first, then vq_params, then
    params, as the JAX package reads its VQ training state) or a port step
    directory."""
    device = resolve_device(device)
    if not _is_native(path):
        return convert_ref.vq_from_state_dict(load_torch_file(path), cfg, dtype, device)
    tree = load_native_checkpoint(path)
    for key in ("ema_params", "vq_params", "params"):
        if isinstance(tree.get(key), Mapping):
            tree = tree[key]
            break
    if _is_flat(tree):
        return convert._build(lambda: vq_model.VQModel(cfg), tree, dtype, device)
    return convert.vq_from_jax(tree, cfg, dtype, device)


def load_adapter_checkpoint(path: str, cfg: vit_model.ViTConfig = vit_model.DINOV2_SMALL,
                            flavor: str = "dinov2", dtype: torch.dtype = torch.float32,
                            device="cuda") -> vit_model.ViT:
    """The adapter backbone from an HF state dict file (.pt / .bin /
    .safetensors; `convert_ref.vit_from_hf_state_dict`), a JAX .npz dump
    (its parameters, or a control state's "adapter") or a port step
    directory (its `ControlModel`'s "adapter." parameters)."""
    device = resolve_device(device)
    if not _is_native(path):
        return convert_ref.vit_from_hf_state_dict(load_torch_file(path), cfg, flavor, dtype,
                                                  device)
    params = native_params(load_native_checkpoint(path), "adapter")
    if _is_flat(params):
        return convert._build(lambda: vit_model.ViT(cfg), params, dtype, device)
    return convert.vit_from_jax(params, cfg, dtype, device)


def _t5_key(name: str) -> bool:
    return name == "shared.weight" or name.startswith("encoder.")


def _t5_files(path: str):
    """The weight files of an HF checkout (or the file itself): one
    model.safetensors, the shards of model.safetensors.index.json, else
    pytorch_model.bin or the shards of its index."""
    if os.path.isfile(path):
        return [path]
    for single, index in (("model.safetensors", "model.safetensors.index.json"),
                          ("pytorch_model.bin", "pytorch_model.bin.index.json")):
        if os.path.isfile(os.path.join(path, single)):
            return [os.path.join(path, single)]
        if os.path.isfile(os.path.join(path, index)):
            with open(os.path.join(path, index)) as f:
                shards = json.load(f)["weight_map"]
            return [os.path.join(path, s) for s in
                    sorted({s for k, s in shards.items() if _t5_key(k)})]
    raise FileNotFoundError(f"{path} holds no model.safetensors, pytorch_model.bin or shard "
                            "index")


def load_t5_encoder(path: str, cfg: t5_model.T5Config = t5_model.T5_XL,
                    dtype: torch.dtype = torch.float32, device="cuda") -> t5_model.T5Encoder:
    """The text encoder from a local HF T5 checkout (flan-t5-xl, encoder-only
    or seq2seq) or one weight file: only `shared.weight` and `encoder.*` are
    read (from .safetensors, their byte ranges; a .bin is memory-mapped)."""
    device = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}
    for f in _t5_files(path):
        if f.endswith(".safetensors"):
            sd.update(load_safetensors(f, keep=_t5_key))
        else:
            full = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
            sd.update({k: v for k, v in full.items() if _t5_key(k)})
    return convert_ref.t5_from_state_dict(sd, cfg, dtype, device)
