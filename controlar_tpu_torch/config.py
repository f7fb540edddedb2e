"""Model configuration for the PyTorch port.

The port's own copy of `GPTConfig`, `VQConfig`, their registries and
`find_multiple`, field for field the same as the JAX package's
`controlar_tpu/config.py`, so that one configuration means the same model in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def find_multiple(n: int, k: int) -> int:
    """Round n up to a multiple of k."""
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """LlamaGen-style decoder with ControlAR control fusion."""

    dim: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    initializer_range: float = 0.02

    token_dropout_p: float = 0.1
    attn_dropout_p: float = 0.0
    resid_dropout_p: float = 0.1
    ffn_dropout_p: float = 0.1
    drop_path_rate: float = 0.0

    num_classes: int = 1000
    caption_dim: int = 2048
    class_dropout_prob: float = 0.1
    model_type: str = "c2i"  # 'c2i' | 't2i'

    vocab_size: int = 16384
    cls_token_num: int = 1
    block_size: int = 256
    # explicit (rows, cols) token grid for non-square images; block_size must
    # equal rows * cols
    grid_hw: Optional[Tuple[int, int]] = None
    adapter_size: str = "small"  # 'small' (384-d) | 'base' (768-d)
    condition_type: str = "canny"
    # number of evenly spaced layers that receive control-token fusion
    n_fusion_points: int = 3

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size."""
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return find_multiple(hidden, self.multiple_of)

    @property
    def layer_interval(self) -> int:
        return self.n_layer // self.n_fusion_points

    @property
    def adapter_dim(self) -> int:
        return {"small": 384, "base": 768}[self.adapter_size]

    @property
    def grid(self) -> Tuple[int, int]:
        if self.grid_hw is not None:
            gh, gw = self.grid_hw
            assert gh * gw == self.block_size, (self.grid_hw, self.block_size)
            return gh, gw
        g = int(self.block_size ** 0.5)
        assert g * g == self.block_size, "block_size must be square (or set grid_hw)"
        return g, g

    @property
    def grid_size(self) -> int:
        g = int(self.block_size ** 0.5)
        assert g * g == self.block_size, "block_size must be a square"
        return g

    def with_resolution(self, grid_h: int, grid_w: int) -> "GPTConfig":
        """The configuration for a (grid_h, grid_w) token grid: the weights
        do not depend on the resolution (RoPE has no parameters), and the
        rectangular RoPE table is built from `grid`."""
        return dataclasses.replace(self, block_size=grid_h * grid_w, grid_hw=(grid_h, grid_w))

    @property
    def max_seq_len(self) -> int:
        """cls prefix + image tokens, padded to a multiple of 8."""
        return find_multiple(self.cls_token_num + self.block_size, 8)


_GPT_SIZES = {
    "GPT-B": dict(n_layer=12, n_head=12, dim=768),       # 111M
    "GPT-L": dict(n_layer=24, n_head=16, dim=1024),      # 343M
    "GPT-XL": dict(n_layer=36, n_head=20, dim=1280),     # 775M
    "GPT-XXL": dict(n_layer=48, n_head=24, dim=1536),    # 1.4B
    "GPT-XXXL": dict(n_layer=48, n_head=40, dim=2560),   # 3.9B
    "GPT-1B": dict(n_layer=22, n_head=32, dim=2048),     # 1.2B
    "GPT-3B": dict(n_layer=24, n_head=32, dim=3200),     # 3.1B
    "GPT-7B": dict(n_layer=32, n_head=32, dim=4096),     # 6.6B
}

GPT_SIZES = tuple(_GPT_SIZES)


def gpt_config(size: str, **overrides) -> GPTConfig:
    """Build a GPTConfig from a registry size name plus overrides."""
    if size not in _GPT_SIZES:
        raise KeyError(f"unknown GPT size {size!r}; options: {sorted(_GPT_SIZES)}")
    kw = dict(_GPT_SIZES[size])
    kw.update(overrides)
    return GPTConfig(**kw)


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """VQGAN tokenizer config."""

    codebook_size: int = 16384
    codebook_embed_dim: int = 8
    codebook_l2_norm: bool = True
    commit_loss_beta: float = 0.25
    entropy_loss_ratio: float = 0.0
    encoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    decoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    z_channels: int = 256
    ch: int = 128
    num_res_blocks: int = 2
    dropout_p: float = 0.0

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.encoder_ch_mult) - 1)


_VQ_SIZES = {
    "VQ-16": dict(encoder_ch_mult=(1, 1, 2, 2, 4), decoder_ch_mult=(1, 1, 2, 2, 4)),
    "VQ-8": dict(encoder_ch_mult=(1, 2, 2, 4), decoder_ch_mult=(1, 2, 2, 4)),
}


def vq_config(name: str, **overrides) -> VQConfig:
    kw = dict(_VQ_SIZES[name])
    kw.update(overrides)
    return VQConfig(**kw)
