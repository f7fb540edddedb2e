"""End-to-end generation: condition image -> control tokens -> CFG decode
(plain or speculative) -> VQ decode -> uint8 image. Images are NHWC at the
boundary, as in the JAX package's `ControlARPipeline`."""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import spec_decode
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.models import control_nets
from controlar_tpu_torch.models import dpt as dpt_model
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.ops.resize import to_patch14
from controlar_tpu_torch.quant import quantize_gpt


def normalize_condition(x: torch.Tensor) -> torch.Tensor:
    """uint8-range control map -> [-1, 1]."""
    return 2.0 * (x.float() / 255.0 - 0.5)


def to_uint8_image(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] NHWC float -> uint8 (clamp, scale, round half up). Raises on
    non-finite values, which have no image."""
    if not bool(torch.isfinite(x).all()):
        raise ValueError("decoded image holds non-finite values")
    x = torch.clamp(x.float(), -1.0, 1.0)
    return ((255.0 * (x + 1.0) / 2.0) + 0.5).to(torch.uint8).cpu().numpy()


@dataclasses.dataclass
class ControlARPipeline:
    gpt_cfg: GPTConfig
    gpt: gpt_model.GPT
    vq_cfg: VQConfig
    vq: vq_model.VQModel
    adapter_cfg: vit_model.ViTConfig
    adapter: vit_model.ViT
    condition_type: str = "canny"
    device: Union[str, torch.device] = "cuda"
    # the condition networks (fp32 modules on the pipeline's device)
    hed: Optional[control_nets.HED] = None
    lineart: Optional[control_nets.Lineart] = None
    dpt: Optional[dpt_model.DPT] = None
    dpt_cfg: Optional[dpt_model.DPTConfig] = None
    midas: Optional[midas_model.MidasHybrid] = None  # the MiDaS DPT-Hybrid detector
    midas_cfg: Optional[midas_model.MidasHybridConfig] = None
    depth_fn: Optional[Callable] = None  # (B, H, W, 3) uint8 -> (B, H, W) 0..255
    # a smaller family member drafting for the GPT (e.g. GPT-B for GPT-3B),
    # used by generate(spec_draft="model" | "model-int8")
    draft_gpt_cfg: Optional[GPTConfig] = None
    draft_gpt: Optional[gpt_model.GPT] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for module in (self.gpt, self.vq, self.adapter, self.draft_gpt, self.hed,
                       self.lineart, self.dpt, self.midas):
            if module is not None:
                check_on(module, self.device)

    @torch.inference_mode()
    def extract_condition(self, images_u8, *, canny_low: int = 100,
                          canny_high: int = 200, preprocess: bool = True) -> torch.Tensor:
        """RGB uint8 (B, H, W, 3) -> normalised 3-channel control map
        (`control_nets.condition_map` of the pipeline's type and networks).
        preprocess=False (and 'seg') treats the input as a rendered map."""
        x = torch.as_tensor(np.asarray(images_u8), device=self.device)
        ct = self.condition_type
        if not preprocess or ct == "seg":
            cond = x.float().mean(-1)
        else:
            cond = control_nets.condition_map(
                ct, x, hed=self.hed, lineart=self.lineart, depth_fn=self.depth_fn,
                midas=self.midas, midas_cfg=self.midas_cfg, dpt=self.dpt, dpt_cfg=self.dpt_cfg,
                canny_low=canny_low, canny_high=canny_high).float()
        return normalize_condition(cond[..., None].expand(*cond.shape, 3))

    @torch.inference_mode()
    def control_features(self, condition: torch.Tensor) -> torch.Tensor:
        """Normalised condition (B, H, W, 3) -> adapter tokens (B, hw/256, C)."""
        x = to_patch14(condition, self.condition_type)
        x = x.to(gpt_model.param_dtype(self.adapter))
        return vit_model.vit_forward(self.adapter, self.adapter_cfg, x)

    def generate(
        self,
        *,
        labels=None,
        caption_emb=None,
        emb_masks=None,
        condition_images: Optional[np.ndarray] = None,
        cfg_scale: float = 4.0,
        temperature: float = 1.0,
        top_k: int = 2000,
        top_p: float = 1.0,
        control_strength: float = 1.0,
        seed: int = 0,
        cache_dtype=None,
        canny_low: int = 100,
        canny_high: int = 200,
        preprocess_condition: bool = True,
        spec_draft: Optional[str] = None,
        timings: Optional[dict] = None,
        on_step: Optional[Callable[[int], None]] = None,
        spec_stats: Optional[dict] = None,
    ) -> np.ndarray:
        """Returns generated images as uint8 (B, H, W, 3). cache_dtype
        torch.int8 or "int4" selects a quantized KV cache (it pairs with a
        GPT quantized by `quant.quantize_gpt`); None keeps the bf16 cache.

        spec_draft decodes speculatively (`spec_decode.generate_spec`, k = 4
        drafts per cycle); Leviathan accept/reject keeps the distribution the
        plain sampler draws from:
          "int8" | "w4"          a quantized copy of the GPT drafts for it
                                 ("w4" without the split-rope layout);
          "model" | "model-int8" the pipeline's draft_gpt, as it is or a
                                 W8 copy of it.
        The draft's cache has the GPT's cache dtype; the GPT and draft_gpt
        are left unchanged. `spec_stats`, when given, receives the call's
        accepted_per_cycle, k_draft and loop_iters.

        `timings`, when given, receives the host-clock seconds of each stage
        (condition, adapter, tokens, vq_decode), with the device synchronised
        at every stage's end. `on_step(i)` is called after decode step i, or
        after cycle i of a speculative call."""
        draft, draft_cfg = self._draft(spec_draft)
        lap = _StageClock(self.device, timings)
        adapter_feats = None
        if condition_images is not None:
            cond = self.extract_condition(
                condition_images, canny_low=canny_low, canny_high=canny_high,
                preprocess=preprocess_condition)
            lap("condition")
            adapter_feats = self.control_features(cond)
            lap("adapter")
        common = dict(
            labels=labels, caption_emb=caption_emb, emb_masks=emb_masks,
            adapter_features=adapter_feats,
            max_new_tokens=self.gpt_cfg.block_size,
            cfg_scale=cfg_scale, temperature=temperature, top_k=top_k, top_p=top_p,
            control_strength=control_strength, seed=seed, device=self.device,
            cache_dtype=torch.bfloat16 if cache_dtype is None else cache_dtype,
            on_step=on_step,
        )
        if draft is None:
            tokens = tgen.generate(self.gpt, self.gpt_cfg, **common)
        else:
            tokens, stats = spec_decode.generate_spec(
                self.gpt, self.gpt_cfg, draft, draft_cfg, return_stats=True, **common)
            if spec_stats is not None:
                spec_stats.update(stats)
        lap("tokens")
        gh, gw = self.gpt_cfg.grid
        imgs = to_uint8_image(
            vq_model.decode_code(self.vq, self.vq_cfg, tokens.reshape(-1, gh, gw)))
        lap("vq_decode")
        return imgs


    def _draft(self, spec_draft: Optional[str]):
        """-> (draft GPT, its config) for spec_draft, or (None, None). A
        quantized draft is a quantized copy: the GPT and draft_gpt stay as
        they are."""
        if spec_draft is None:
            return None, None
        if spec_draft in ("model", "model-int8"):
            if self.draft_gpt is None:
                raise ValueError(f"spec_draft={spec_draft!r} needs draft_gpt and draft_gpt_cfg "
                                 "on the pipeline")
            if spec_draft == "model":
                return self.draft_gpt, self.draft_gpt_cfg
            return (quantize_gpt(copy.deepcopy(self.draft_gpt), self.draft_gpt_cfg, "int8"),
                    self.draft_gpt_cfg)
        if spec_draft in ("int8", "w4"):
            return quantize_gpt(copy.deepcopy(self.gpt), self.gpt_cfg, spec_draft), self.gpt_cfg
        raise ValueError(f"spec_draft must be 'int8', 'w4', 'model' or 'model-int8', "
                         f"got {spec_draft!r}")


class _StageClock:
    """lap(name) stores the seconds since the previous lap in `timings`;
    does nothing when `timings` is None."""

    def __init__(self, device: torch.device, timings: Optional[dict]):
        self.device, self.timings = device, timings
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.last
        self.last = now
