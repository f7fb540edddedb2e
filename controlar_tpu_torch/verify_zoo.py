"""Released-checkpoint parity gate: greedy token equality between the
reference's torch model and the port (the JAX package's `verify_zoo.py`).

The moment a released `.pt` / `.safetensors` ControlAR checkpoint is on disk,

    python -m controlar_tpu_torch.cli verify-zoo CKPT --size GPT-XL --model-type t2i

loads it into both the imported reference model (`REFERENCE_ROOT`, its
adapter backbones replaced by identities) and the port
(`checkpoint.load_gpt_checkpoint`), runs greedy generation on the same
seed-made inputs, and reports PASS / FAIL on exact token equality.
`--self-test` pushes a tiny random reference model through the same path.

Scope, as in the JAX package: the gate holds the transformer's weights
(embedders, control MLPs, fusion layers, attention and FFN, head); both
sides take the same precomputed adapter features. Both sides run in fp32
(the reference's bf16 cast of the condition is undone), the port with its
fp32 cache through the masked einsum, so argmax ties cannot part on
rounding. The reference must be importable: without `REFERENCE_ROOT` the
gate raises (it never passes without running).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import types
from typing import Any, Dict, Optional

import numpy as np
import torch

from controlar_tpu_torch import resolve_device

REFERENCE_ROOT = "/root/reference"


def _add_reference_path():
    if not os.path.isdir(os.path.join(REFERENCE_ROOT, "autoregressive")):
        raise FileNotFoundError(
            f"the reference implementation is not at {REFERENCE_ROOT} (its "
            "autoregressive/ package): the gate compares the port against the reference's "
            "torch model and cannot run without it")
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)


def load_ref_gpt_module(t2i: bool):
    """The reference's GPT module (gpt_t2i for t2i), its adapter backbones
    replaced by identities."""
    _add_reference_path()
    import importlib

    import torch.nn as nn

    class _IdentityAdapter(nn.Module):
        def __init__(self, *a, **k):
            super().__init__()

        def forward(self, x):
            return x

    for adapter_mod, cls in (("autoregressive.models.vit_adapter", "ViT_Adapter"),
                             ("autoregressive.models.dinov2_adapter", "Dinov2_Adapter")):
        if adapter_mod not in sys.modules:
            m = types.ModuleType(adapter_mod)
            setattr(m, cls, _IdentityAdapter)
            sys.modules[adapter_mod] = m
    mod = importlib.import_module("autoregressive.models.gpt_t2i" if t2i
                                  else "autoregressive.models.gpt")
    if t2i:
        mod.Dinov2_Adapter = _IdentityAdapter
    else:
        mod.ViT_Adapter = _IdentityAdapter
    return mod


def _patch_ref_model(model, t2i: bool):
    """fp32 condition path and control_strength pass-through for c2i (the
    reference's c2i Transformer.forward does not take the keyword its
    shared generate.py sends)."""
    if t2i:
        return
    cm = model.condition_mlp
    orig_cm = cm.forward

    def cm_fwd(caption, train=False, force_drop_ids=None, drop_ids=None):
        return orig_cm(caption.float(), train, force_drop_ids, drop_ids)

    cm.forward = cm_fwd
    orig = model.forward

    def fwd(*args, control_strength=1, **kw):
        return orig(*args, **kw)

    model.forward = fwd


# the released checkpoint zoo (the reference's README.md:60-67): file name ->
# gate configuration; `verify-zoo --zoo-dir DIR` gates every file found in DIR
ZOO = {
    "canny_MR.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="small",
                                 block_size=1024),
    "depth_MR.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="small",
                                 block_size=1024),
    "hed.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="small",
                            block_size=1024),
    "seg_cocostuff.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="small",
                                      block_size=1024),
    "edge_base.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="base",
                                  block_size=1024),
    "depth_base.safetensors": dict(size="GPT-XL", model_type="t2i", adapter_size="base",
                                   block_size=1024),
}


def verify_zoo_dir(zoo_dir: str, max_new_tokens: Optional[int] = 64, device="cuda"):
    """Gate every known zoo file present in zoo_dir. Returns GateResults."""
    results = []
    for name, kw in ZOO.items():
        path = os.path.join(zoo_dir, name)
        if os.path.exists(path):
            results.append(verify_checkpoint(path, name=name, max_new_tokens=max_new_tokens,
                                             device=device, **kw))
    return results


@dataclasses.dataclass
class GateResult:
    name: str
    agreement: float
    n_tokens: int
    passed: bool
    quant: Optional[Dict[str, Dict[str, float]]] = None  # eval/quant_report

    def line(self) -> str:
        status = "PASS" if self.passed else "FAIL"
        out = (f"[{status}] {self.name}: {self.agreement*100:.2f}% of "
               f"{self.n_tokens} greedy tokens match")
        if self.quant:
            for mode, m in self.quant.items():
                out += (f"\n    quant {mode}: teacher-forced agreement "
                        f"{m['teacher_forced_agreement']*100:.1f}%, max rel "
                        f"logit err {m['max_rel_logit_err']:.4f}")
        return out


def _build_ref_model(model_type: str, cfg, overrides: Dict[str, Any]):
    t2i = model_type == "t2i"
    ref_mod = load_ref_gpt_module(t2i)
    common = dict(n_layer=cfg.n_layer, n_head=cfg.n_head, dim=cfg.dim,
                  block_size=cfg.block_size, vocab_size=cfg.vocab_size,
                  num_classes=cfg.num_classes, caption_dim=cfg.caption_dim,
                  token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
                  drop_path_rate=0.0)
    common.update(overrides)
    if t2i:
        args = ref_mod.ModelArgs(model_type="t2i", cls_token_num=cfg.cls_token_num,
                                 adapter_size=cfg.adapter_size, **common)
    else:
        args = ref_mod.ModelArgs(model_type="c2i", cls_token_num=cfg.cls_token_num,
                                 condition_token_num=0, **common)
    torch.manual_seed(0)
    return ref_mod, ref_mod.Transformer(args).float()


def verify_checkpoint(
    ckpt_path: str,
    size: str,
    model_type: str = "t2i",
    adapter_size: str = "small",
    max_new_tokens: Optional[int] = None,
    cls_token_num: Optional[int] = None,
    block_size: int = 1024,
    cfg_scale: float = 2.0,
    batch: int = 2,
    seed: int = 0,
    name: Optional[str] = None,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    ref_overrides: Optional[Dict[str, Any]] = None,
    quant_report: bool = False,
    device="cuda",
) -> GateResult:
    """Run the gate on one checkpoint file (the reference on the CPU, the
    port on `device`). quant_report=True also measures the int8 / W4
    serving modes' agreement against the bf16 weights (c2i)."""
    import importlib

    from controlar_tpu_torch import checkpoint as ckpt_lib
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.config import gpt_config

    dev = resolve_device(device)
    t2i = model_type == "t2i"
    if cls_token_num is None:
        cls_token_num = 120 if t2i else 1
    cfg = gpt_config(size, model_type=model_type, cls_token_num=cls_token_num,
                     block_size=block_size, adapter_size=adapter_size, token_dropout_p=0.0,
                     resid_dropout_p=0.0, ffn_dropout_p=0.0, **(cfg_overrides or {}))
    max_new = max_new_tokens or cfg.block_size

    sd = ckpt_lib.load_torch_file(ckpt_path)
    ref_mod, model = _build_ref_model(model_type, cfg, ref_overrides or {})
    missing, _ = model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=False)
    # the replaced adapter backbones miss their weights; anything else missing
    # means the checkpoint does not match the claimed size or type
    bad_missing = [k for k in missing if not k.startswith("adapter.")]
    if bad_missing:
        raise ValueError(f"checkpoint lacks {len(bad_missing)} model keys (first: "
                         f"{bad_missing[:3]}): wrong --size / --model-type?")
    _patch_ref_model(model, t2i)
    model.eval()
    port = ckpt_lib.load_gpt_checkpoint(ckpt_path, cfg, torch.float32, dev)

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((batch, cfg.block_size, cfg.adapter_dim)).astype(np.float32)
    gen_mod = importlib.import_module("autoregressive.models.generate")
    common = dict(max_new_tokens=max_new, cfg_scale=cfg_scale, sample_logits=False,
                  cache_dtype=torch.float32, use_flash=False, device=dev)
    if t2i:
        cap = rng.standard_normal((batch, cfg.cls_token_num, cfg.caption_dim)).astype(np.float32)
        emb = np.ones((batch, cfg.cls_token_num), np.float32)
        emb[0, : cfg.cls_token_num // 4] = 0  # left-padded caption
        with torch.no_grad():
            want = gen_mod.generate(
                model, torch.from_numpy(cap), max_new, emb_masks=torch.from_numpy(emb),
                cfg_scale=cfg_scale, condition=torch.from_numpy(feats), temperature=1.0,
                top_k=0, top_p=1.0, sample_logits=False, control_strength=1.0).numpy()
        got = tgen.generate(port, cfg, caption_emb=cap, emb_masks=emb, adapter_features=feats,
                            control_strength=1.0, **common)
    else:
        labels = rng.integers(0, cfg.num_classes, (batch,)).astype(np.int64)
        with torch.no_grad():
            want = gen_mod.generate(
                model, torch.from_numpy(labels), max_new, cfg_scale=cfg_scale,
                condition=torch.from_numpy(feats), temperature=1.0, top_k=0, top_p=1.0,
                sample_logits=False).numpy()
        got = tgen.generate(port, cfg, labels=labels, adapter_features=feats, **common)
    agreement = float((got.cpu().numpy() == want).mean())
    qrep = None
    if quant_report and not t2i:
        from controlar_tpu_torch.eval.quant_report import measure_quant_agreement

        qrep = measure_quant_agreement(port.to(torch.bfloat16), cfg,
                                       max_new_tokens=min(max_new, 128), device=dev)
    return GateResult(name=name or ckpt_path, agreement=agreement,
                      n_tokens=int(np.prod(want.shape)), passed=agreement == 1.0, quant=qrep)


def self_test(model_type: str = "t2i", tmp_dir: Optional[str] = None,
              device="cuda") -> GateResult:
    """The gate without released weights: a tiny random reference model's
    state_dict on disk through `verify_checkpoint`. Raises when the
    reference is not importable."""
    import tempfile

    from controlar_tpu_torch.config import _GPT_SIZES, gpt_config

    t2i = model_type == "t2i"
    _GPT_SIZES.setdefault("GPT-TEST", dict(n_layer=6, n_head=2, dim=64))
    cfg = gpt_config("GPT-TEST", model_type=model_type, cls_token_num=120 if t2i else 1,
                     block_size=64, vocab_size=512, num_classes=16, caption_dim=96)
    overrides = dict(image_size=128) if not t2i else {}
    _, model = _build_ref_model(model_type, cfg, overrides)
    # random weights for the zero-initialised control MLPs, so that fusion
    # is a real part of the check
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.abs().sum() == 0 and p.ndim == 2:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    tmp_dir = tmp_dir or tempfile.mkdtemp()
    path = os.path.join(tmp_dir, f"selftest_{model_type}.pt")
    torch.save({"model": model.state_dict()}, path)
    return verify_checkpoint(
        path, "GPT-TEST", model_type=model_type, block_size=64,
        cls_token_num=120 if t2i else 1, max_new_tokens=64, name=f"self-test ({model_type})",
        cfg_overrides=dict(vocab_size=512, num_classes=16, caption_dim=96),
        ref_overrides=overrides, device=device)
