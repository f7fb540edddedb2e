"""mmseg reward-model checkpoints for the mIoU evals (the JAX package's
`convert/mmseg_seg.py`; its function names).

The reference scores mIoU with two mmseg-trained checkpoints:
  - Mask2Former-SwinL ADE20K-150
    (mask2former_swin-l-in22k-384x384-pre_..._ade20k-640x640_*.pth)
  - DeepLabV3-R101-d8 COCOStuff-171
    (deeplabv3_r101-d8_512x512_4x4_320k_coco-stuff164k_*.pth)

Without mmseg:
  - DeepLabV3 loads into the port's own torch module, whose module tree
    mirrors mmseg's keys (eval/deeplabv3.py): identity key mapping.
  - Mask2Former is key-converted into transformers'
    Mask2FormerForUniversalSegmentation (the same architecture), every
    hyperparameter inferred from tensor shapes. The conversion is plain
    torch; building the model imports transformers, inside
    `mask2former_config_from_mmseg` and `load_mmseg_mask2former` only.

Key layout: mmseg dev-1.x / mmdet 3.x module naming (SwinTransformer
`stages.*.blocks.*.attn.w_msa`, MSDeformAttnPixelDecoder,
Mask2FormerTransformerDecoder); unmatched keys raise.

The numerically non-trivial remappings:
  - fused qkv -> separate q / k / v splits,
  - mmcv PatchMerging samples the 2x2 window with nn.Unfold, channel-major
    (c*4 + dy*2+dx), while HF Swin concatenates position-major
    ([x(0,0); x(1,0); x(0,1); x(1,1)] each C wide): the downsample
    reduction / norm inputs are permuted accordingly,
  - the mmdet decoder layer's norms are ordered (cross, self, ffn).

The segmenter's front end (`_keep_ratio_resize`: mmseg's keep-ratio resize
and ImageNet mean / std) runs on the card. A checkpoint is read with
`torch.load(weights_only=True)`: one that pickles other objects than
tensors and plain containers is refused.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.eval.deeplabv3 import DeepLabV3


def _t(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


def strip_mmseg_checkpoint(ckpt: Mapping) -> Dict:
    """Accept either a raw state dict or mmseg's {'state_dict': ..., 'meta': ...}."""
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: _t(v) for k, v in ckpt.items()}


def detect_mmseg_kind(sd: Mapping) -> str:
    if any(k.startswith("decode_head.pixel_decoder.") for k in sd):
        return "mask2former"
    if any(k.startswith("decode_head.aspp_modules.") for k in sd):
        return "deeplabv3"
    raise ValueError(
        "unrecognized mmseg checkpoint: expected Mask2Former "
        "(decode_head.pixel_decoder.*) or DeepLabV3 (decode_head.aspp_modules.*)"
    )


# ---------------------------------------------------------------- deeplabv3


def load_mmseg_deeplabv3(sd: Mapping):
    """Build eval/deeplabv3.DeepLabV3 and load an mmseg state dict into it
    (on the CPU, the state dict's tensors assigned). -> (model, classes)."""
    sd = strip_mmseg_checkpoint(sd)
    num_classes = sd["decode_head.conv_seg.weight"].shape[0]
    head_channels = sd["decode_head.conv_seg.weight"].shape[1]
    base_channels = sd["backbone.stem.6.weight"].shape[0]
    n_layer3 = len({k.split(".")[2] for k in sd
                    if k.startswith("backbone.layer3.")})
    depth = {6: 50, 23: 101}[n_layer3]
    with torch.device("meta"):
        model = DeepLabV3(depth=depth, num_classes=num_classes,
                          base_channels=base_channels,
                          head_channels=head_channels)
    own = {k for k in model.state_dict()}
    load = {k: v for k, v in sd.items() if k in own}
    extra = [k for k in sd if k not in own
             and not k.startswith("auxiliary_head.")]
    if extra:
        raise ValueError(f"unmatched mmseg DeepLabV3 keys: {extra[:8]}...")
    missing = own - set(load)
    if missing:
        raise ValueError(f"mmseg DeepLabV3 checkpoint missing: "
                         f"{sorted(missing)[:8]}...")
    model.load_state_dict(load, strict=True, assign=True)
    return model.eval().requires_grad_(False), num_classes


# --------------------------------------------------------------- mask2former


def _stage_blocks(sd, prefix="backbone.stages."):
    stages: Dict[int, int] = {}
    for k in sd:
        if k.startswith(prefix) and ".blocks." in k:
            parts = k[len(prefix):].split(".")
            i, j = int(parts[0]), int(parts[2])
            stages[i] = max(stages.get(i, 0), j + 1)
    return [stages[i] for i in sorted(stages)]


def mask2former_config_from_mmseg(sd: Mapping, num_attention_heads=None):
    """Infer a transformers Mask2FormerConfig from mmseg tensor shapes.

    num_attention_heads (8 in the released SwinL-ADE model) is inferred from
    the deformable-attention sampling_offsets rows = heads * levels * 4pts * 2
    unless given explicitly."""
    from transformers import Mask2FormerConfig, SwinConfig

    embed_dim = sd["backbone.patch_embed.projection.weight"].shape[0]
    depths = _stage_blocks(sd)
    num_heads = [
        sd[f"backbone.stages.{i}.blocks.0.attn.w_msa."
           f"relative_position_bias_table"].shape[1]
        for i in range(len(depths))
    ]
    table_rows = sd["backbone.stages.0.blocks.0.attn.w_msa."
                    "relative_position_bias_table"].shape[0]
    window = (int(round(table_rows ** 0.5)) + 1) // 2
    mlp_ratio = (sd["backbone.stages.0.blocks.0.ffn.layers.0.0.weight"]
                 .shape[0] / embed_dim)
    hidden_dim = sd["decode_head.query_embed.weight"].shape[1]
    num_queries = sd["decode_head.query_embed.weight"].shape[0]
    num_labels = sd["decode_head.cls_embed.weight"].shape[0] - 1
    mask_feature_size = sd["decode_head.pixel_decoder.mask_feature.weight"].shape[0]
    enc_layers = len({k.split(".")[4] for k in sd if k.startswith(
        "decode_head.pixel_decoder.encoder.layers.")})
    dec_layers = len({k.split(".")[3] for k in sd if k.startswith(
        "decode_head.transformer_decoder.layers.")})
    enc_ffn = sd["decode_head.pixel_decoder.encoder.layers.0.ffn."
                 "layers.0.0.weight"].shape[0]
    dec_ffn = sd["decode_head.transformer_decoder.layers.0.ffn."
                 "layers.0.0.weight"].shape[0]
    if num_attention_heads is None:
        n_levels = sd["decode_head.pixel_decoder.level_encoding.weight"].shape[0]
        off_rows = sd["decode_head.pixel_decoder.encoder.layers.0."
                      "self_attn.sampling_offsets.weight"].shape[0]
        num_attention_heads = off_rows // (2 * n_levels * 4)
    bb = SwinConfig(
        image_size=384, embed_dim=embed_dim, depths=depths,
        num_heads=num_heads, window_size=window, mlp_ratio=mlp_ratio,
        out_features=[f"stage{i + 1}" for i in range(len(depths))],
    )
    return Mask2FormerConfig(
        backbone_config=bb, feature_size=mask_feature_size,
        mask_feature_size=mask_feature_size, hidden_dim=hidden_dim,
        encoder_layers=enc_layers,
        # HF builds config.decoder_layers - 1 actual layers
        decoder_layers=dec_layers + 1,
        num_attention_heads=num_attention_heads,
        encoder_feedforward_dim=enc_ffn, dim_feedforward=dec_ffn,
        num_queries=num_queries, num_labels=num_labels,
    )


def _merge_perm(c: int):
    """Input-channel permutation for PatchMerging reduction/norm:
    HF index p*C+c reads mmcv-unfold index c*4 + u(p), u = [0, 2, 1, 3]."""
    u = [0, 2, 1, 3]
    return [ch * 4 + u[p] for p in range(4) for ch in range(c)]


def convert_mask2former_state(sd: Mapping) -> Tuple[Dict, list]:
    """mmseg Mask2Former state dict -> HF Mask2Former state dict.

    Returns (hf_state_dict, unmatched_mmseg_keys).
    """
    sd = strip_mmseg_checkpoint(sd)
    out: Dict = {}
    used = set()

    def take(mm_key):
        used.add(mm_key)
        return sd[mm_key]

    def copy(mm_key, hf_key):
        out[hf_key] = take(mm_key)

    def copy_wb(mm_prefix, hf_prefix):
        copy(f"{mm_prefix}.weight", f"{hf_prefix}.weight")
        if f"{mm_prefix}.bias" in sd:
            copy(f"{mm_prefix}.bias", f"{hf_prefix}.bias")

    def split_qkv(mm_prefix, hf_prefixes, sep="."):
        # sep "." for Linear (qkv.weight), "_" for MultiheadAttention
        # packed projections (in_proj_weight)
        w = take(f"{mm_prefix}{sep}weight")
        b = (take(f"{mm_prefix}{sep}bias")
             if f"{mm_prefix}{sep}bias" in sd else None)
        ws = torch.chunk(w, 3, dim=0)
        bs = torch.chunk(b, 3, dim=0) if b is not None else (None,) * 3
        for hf, wi, bi in zip(hf_prefixes, ws, bs):
            out[f"{hf}.weight"] = wi
            if bi is not None:
                out[f"{hf}.bias"] = bi

    # ---- swin backbone
    enc = "model.pixel_level_module.encoder"
    copy_wb("backbone.patch_embed.projection",
            f"{enc}.embeddings.patch_embeddings.projection")
    copy_wb("backbone.patch_embed.norm", f"{enc}.embeddings.norm")
    depths = _stage_blocks(sd)
    embed_dim = sd["backbone.patch_embed.projection.weight"].shape[0]
    for i, depth in enumerate(depths):
        for j in range(depth):
            mm = f"backbone.stages.{i}.blocks.{j}"
            hf = f"{enc}.encoder.layers.{i}.blocks.{j}"
            copy_wb(f"{mm}.norm1", f"{hf}.layernorm_before")
            copy_wb(f"{mm}.norm2", f"{hf}.layernorm_after")
            copy(f"{mm}.attn.w_msa.relative_position_bias_table",
                 f"{hf}.attention.self.relative_position_bias_table")
            if f"{mm}.attn.w_msa.relative_position_index" in sd:
                copy(f"{mm}.attn.w_msa.relative_position_index",
                     f"{hf}.attention.self.relative_position_index")
            split_qkv(f"{mm}.attn.w_msa.qkv",
                      [f"{hf}.attention.self.query",
                       f"{hf}.attention.self.key",
                       f"{hf}.attention.self.value"])
            copy_wb(f"{mm}.attn.w_msa.proj", f"{hf}.attention.output.dense")
            copy_wb(f"{mm}.ffn.layers.0.0", f"{hf}.intermediate.dense")
            copy_wb(f"{mm}.ffn.layers.1", f"{hf}.output.dense")
        mm_down = f"backbone.stages.{i}.downsample"
        if f"{mm_down}.reduction.weight" in sd:
            c = embed_dim * (2 ** i)
            perm = torch.as_tensor(_merge_perm(c))
            hf_down = f"{enc}.encoder.layers.{i}.downsample"
            out[f"{hf_down}.reduction.weight"] = take(
                f"{mm_down}.reduction.weight")[:, perm]
            out[f"{hf_down}.norm.weight"] = take(f"{mm_down}.norm.weight")[perm]
            out[f"{hf_down}.norm.bias"] = take(f"{mm_down}.norm.bias")[perm]
        copy_wb(f"backbone.norm{i}", f"{enc}.hidden_states_norms.stage{i + 1}")

    # ---- pixel decoder (MSDeformAttn)
    mm_pd, hf_pd = "decode_head.pixel_decoder", "model.pixel_level_module.decoder"
    n_enc_levels = len({k.split(".")[3] for k in sd
                        if k.startswith(f"{mm_pd}.input_convs.")})
    for i in range(n_enc_levels):
        copy_wb(f"{mm_pd}.input_convs.{i}.conv", f"{hf_pd}.input_projections.{i}.0")
        copy_wb(f"{mm_pd}.input_convs.{i}.gn", f"{hf_pd}.input_projections.{i}.1")
    out[f"{hf_pd}.level_embed"] = take(f"{mm_pd}.level_encoding.weight")
    n_enc = len({k.split(".")[4] for k in sd
                 if k.startswith(f"{mm_pd}.encoder.layers.")})
    for i in range(n_enc):
        mm = f"{mm_pd}.encoder.layers.{i}"
        hf = f"{hf_pd}.encoder.layers.{i}"
        for p in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            copy_wb(f"{mm}.self_attn.{p}", f"{hf}.self_attn.{p}")
        copy_wb(f"{mm}.norms.0", f"{hf}.self_attn_layer_norm")
        copy_wb(f"{mm}.norms.1", f"{hf}.final_layer_norm")
        copy_wb(f"{mm}.ffn.layers.0.0", f"{hf}.fc1")
        copy_wb(f"{mm}.ffn.layers.1", f"{hf}.fc2")
    # non-encoder FPN levels: mmseg lateral/output convs -> HF adapter_N/layer_N
    n_lat = len({k.split(".")[3] for k in sd
                 if k.startswith(f"{mm_pd}.lateral_convs.")})
    for i in range(n_lat):
        copy_wb(f"{mm_pd}.lateral_convs.{i}.conv", f"{hf_pd}.adapter_{i + 1}.0")
        copy_wb(f"{mm_pd}.lateral_convs.{i}.gn", f"{hf_pd}.adapter_{i + 1}.1")
        copy_wb(f"{mm_pd}.output_convs.{i}.conv", f"{hf_pd}.layer_{i + 1}.0")
        copy_wb(f"{mm_pd}.output_convs.{i}.gn", f"{hf_pd}.layer_{i + 1}.1")
    copy_wb(f"{mm_pd}.mask_feature", f"{hf_pd}.mask_projection")

    # ---- transformer decoder module
    mm_td = "decode_head.transformer_decoder"
    hf_tm = "model.transformer_module"
    copy("decode_head.query_embed.weight", f"{hf_tm}.queries_embedder.weight")
    copy("decode_head.query_feat.weight", f"{hf_tm}.queries_features.weight")
    copy("decode_head.level_embed.weight", f"{hf_tm}.level_embed.weight")
    copy_wb(f"{mm_td}.post_norm", f"{hf_tm}.decoder.layernorm")
    n_dec = len({k.split(".")[3] for k in sd
                 if k.startswith(f"{mm_td}.layers.")})
    for i in range(n_dec):
        mm = f"{mm_td}.layers.{i}"
        hf = f"{hf_tm}.decoder.layers.{i}"
        # cross-attn: nn.MultiheadAttention on both sides
        copy(f"{mm}.cross_attn.attn.in_proj_weight", f"{hf}.cross_attn.in_proj_weight")
        copy(f"{mm}.cross_attn.attn.in_proj_bias", f"{hf}.cross_attn.in_proj_bias")
        copy_wb(f"{mm}.cross_attn.attn.out_proj", f"{hf}.cross_attn.out_proj")
        # self-attn: HF uses separate q/k/v projections
        split_qkv(f"{mm}.self_attn.attn.in_proj",
                  [f"{hf}.self_attn.q_proj", f"{hf}.self_attn.k_proj",
                   f"{hf}.self_attn.v_proj"], sep="_")
        copy_wb(f"{mm}.self_attn.attn.out_proj", f"{hf}.self_attn.out_proj")
        # mmdet Mask2Former layer order: cross, self, ffn (norms 0/1/2)
        copy_wb(f"{mm}.norms.0", f"{hf}.cross_attn_layer_norm")
        copy_wb(f"{mm}.norms.1", f"{hf}.self_attn_layer_norm")
        copy_wb(f"{mm}.norms.2", f"{hf}.final_layer_norm")
        copy_wb(f"{mm}.ffn.layers.0.0", f"{hf}.fc1")
        copy_wb(f"{mm}.ffn.layers.1", f"{hf}.fc2")
    copy_wb("decode_head.cls_embed", "class_predictor")
    for j, mm_idx in enumerate((0, 2, 4)):
        copy_wb(f"decode_head.mask_embed.{mm_idx}",
                f"{hf_tm}.decoder.mask_predictor.mask_embedder.{j}.0")

    unmatched = [k for k in sd if k not in used]
    return out, unmatched


def load_mmseg_mask2former(sd: Mapping, num_attention_heads=None):
    """Build the HF model from an mmseg Mask2Former checkpoint."""
    from transformers import Mask2FormerForUniversalSegmentation

    sd = strip_mmseg_checkpoint(sd)
    config = mask2former_config_from_mmseg(
        sd, num_attention_heads=num_attention_heads)
    model = Mask2FormerForUniversalSegmentation(config)
    hf_sd, unmatched = convert_mask2former_state(sd)
    if unmatched:
        raise ValueError(f"unmatched mmseg Mask2Former keys: {unmatched[:8]}...")
    missing, unexpected = model.load_state_dict(hf_sd, strict=False)
    # criterion.empty_weight is a training-only buffer; relative_position_index
    # buffers are deterministic and may be absent from the source dict.
    bad_missing = [k for k in missing if k != "criterion.empty_weight"
                   and not k.endswith("relative_position_index")]
    if bad_missing or unexpected:
        raise ValueError(
            f"conversion mismatch: missing={bad_missing[:8]} "
            f"unexpected={list(unexpected)[:8]}")
    return model.eval(), config.num_labels


# ----------------------------------------------------------------- frontend

_IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _keep_ratio_resize(images_u8: np.ndarray, scale: Tuple[int, int], device="cpu"):
    """mmseg Resize(keep_ratio=True) on `device`: factor = min(long / max,
    short / min), sides rounded int(side * f + 0.5), bilinear without
    corner alignment; then ImageNet mean / std. -> (B, 3, h, w) fp32."""
    h, w = images_u8.shape[1:3]
    long_side, short_side = max(scale), min(scale)
    f = min(long_side / max(h, w), short_side / min(h, w))
    nh, nw = int(h * f + 0.5), int(w * f + 0.5)
    x = torch.as_tensor(np.ascontiguousarray(images_u8), device=device)
    x = x.permute(0, 3, 1, 2).float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    mean = torch.as_tensor(_IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.as_tensor(_IMAGENET_STD, device=device).view(1, 3, 1, 1)
    return (x - mean) / std


def load_mmseg_segmenter(
    path: str,
    device="cuda",
    label_offset: "int | None" = None,
    batch_size: int = 2,
) -> Callable[[np.ndarray], np.ndarray]:
    """Load an mmseg reward checkpoint (.pth) into a segment callable with
    eval/miou's contract: images_u8 (B, H, W, 3) -> (B, H, W) int labels,
    run on `device` ('cuda' unless the caller asks for 'cpu').

    Each model's mmseg test pipeline: Mask2Former-ADE resizes keep-ratio to
    (2560, 640), DeepLabV3-COCOStuff to (2048, 512) (512 px on the short
    side at the eval's square images); both normalise with ImageNet mean /
    std. The ADE 1-based label convention (+1) applies when the head has
    150 classes, as make_segmenter's HF path does.
    """
    device = resolve_device(device)
    sd = strip_mmseg_checkpoint(torch.load(path, map_location="cpu", weights_only=True))
    kind = detect_mmseg_kind(sd)
    if kind == "mask2former":
        model, num_labels = load_mmseg_mask2former(sd)
        scale = (2560, 640)
    else:
        model, num_labels = load_mmseg_deeplabv3(sd)
        scale = (2048, 512)
    model = model.to(device)
    offset = label_offset
    if offset is None:
        offset = 1 if num_labels == 150 else 0

    def segment(images_u8: np.ndarray) -> np.ndarray:
        images_u8 = np.asarray(images_u8, np.uint8)
        h, w = images_u8.shape[1:3]
        outs = []
        for i in range(0, len(images_u8), batch_size):
            x = _keep_ratio_resize(images_u8[i:i + batch_size], scale, device)
            with torch.no_grad():
                if kind == "deeplabv3":
                    logits = F.interpolate(model(x), size=(h, w), mode="bilinear",
                                           align_corners=False)
                    outs.append(logits.argmax(1).cpu().numpy())
                else:
                    out = model(pixel_values=x)
                    masks = F.interpolate(out.masks_queries_logits, size=(h, w),
                                          mode="bilinear", align_corners=False)
                    # the semantic combine of HF's post-processing and mmseg's
                    # Mask2Former: the null class dropped
                    cls_prob = out.class_queries_logits.softmax(-1)[..., :-1]
                    seg = torch.einsum("bqc,bqhw->bchw", cls_prob, masks.sigmoid())
                    outs.append(seg.argmax(1).cpu().numpy())
        return np.concatenate(outs).astype(np.int64) + offset

    return segment
