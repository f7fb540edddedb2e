"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
700 W) and the least time, operations and bytes of the work the cells run.

`bound`, `decode_bound`, `train_bound` and `palm_flops` follow the counts the
port's chip smoke test used for its kernel tables: each input byte read once,
each output byte written once; attention's operations over the causal pairs.
"""
from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12   # HBM3
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 on the tensor cores


def bound(nbytes: float, flops: float, flop_rate: float) -> Tuple[float, str]:
    """Least seconds for the work: bytes over the HBM rate or operations over
    the peak rate of their type, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def decode_bound(live_rows: Iterable[int], h: int, d: int, with_bias: bool) -> float:
    """Least seconds of one decode-attention launch (the port's
    `flash_decode` kernel): a bf16 query and output row per batch row, the
    live bf16 K and V rows (position + 1 of each batch row), an fp32 column
    bias when the caption mask is on; 4 D flops per (head, live row) in fp32
    (the kernel's dot products and weighted sum)."""
    rows = list(live_rows)
    live = sum(rows)
    nbytes = 2 * len(rows) * h * d * 2 + live * 2 * h * d * 2 + (live * 4 if with_bias else 0)
    return bound(nbytes, 4 * live * h * d, FP32_FLOPS)[0]


def train_bound(kind: str, b: int, t: int, h: int, d: int, with_bias: bool) -> float:
    """Least seconds of one training-attention launch ("fwd", "dq", "dkv"):
    causal (query, key) pairs, 2 D flops per pair and product (the forward
    two products, dq three, dk / dv four) in bf16 on the tensor cores; each
    bf16 tensor read or written once, the row statistics and the bias in
    fp32."""
    pairs = b * h * t * (t + 1) // 2
    elem = b * t * h * d * 2
    f32_rows = b * h * t * 4
    n_bf16, n_f32, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}[kind]
    nbytes = n_bf16 * elem + n_f32 * f32_rows + (b * t * 4 if with_bias else 0)
    return bound(nbytes, 2 * products * d * pairs, BF16_FLOPS)[0]


def gpt_matmul_params(g: dict) -> Tuple[int, int]:
    """(weights multiplied at every position by the layers, those of the
    output head)."""
    d, f = g["dim"], g["ffn_dim"]
    per_layer = 3 * d * d + d * d + 3 * d * f
    return g["n_layer"] * per_layer, g["vocab_size"] * d


def decode_flops(g: dict, rows: int, positions: Iterable[int]) -> float:
    """Model FLOPs of `rows` sequences run through `positions` (0-based,
    prefix included): 2 x the layers' weights a position, 4 x layers x dim x
    (position + 1) of attention, and 2 x the head's weights at each position
    that predicts an image token (position >= cls - 1)."""
    layers, head = gpt_matmul_params(g)
    cls = g["cls_token_num"]
    total = 0.0
    for p in positions:
        total += 2 * layers + 4 * g["n_layer"] * g["dim"] * (p + 1)
        if p >= cls - 1:
            total += 2 * head
    return rows * total


def palm_flops(g: dict, a: dict, image_px: int, batch: int) -> float:
    """Training FLOPs of one step, PaLM's convention: batch x the sum over
    the GPT and the adapter of 6 N T + 12 L T^2 d, N the matmul parameters
    (every tensor of a layer, counted as the JAX package stacks them, and the
    other tensors of two or more dimensions), T the sequence each runs;
    recomputation not counted."""
    d, f, c, m = g["dim"], g["ffn_dim"], a["hidden_size"], a["mlp_dim"]
    t_gpt = g["cls_token_num"] + g["block_size"] - 1
    n_gpt = g["n_layer"] * (3 * d * d + d * d + 3 * d * f + 2 * d)
    n_gpt += g["vocab_size"] * d * 2  # token embeddings and head
    n_gpt += (g["num_classes"] + 1) * d if g["model_type"] == "c2i" else \
        d * g["caption_dim"] + d * d + g["cls_token_num"] * g["caption_dim"]
    n_gpt += d * g["adapter_dim"] + 3 * d * d + 2 * g["n_fusion_points"] * d * d
    side = image_px // 16 * 14
    t_ad = (side // a["patch_size"]) ** 2 + 1
    n_ad = a["n_layer"] * (4 * c * c + 4 * c + 2 * c * m + m + c + 6 * c)
    n_ad += (a["pos_grid"] ** 2 + 1) * c + c * 3 * a["patch_size"] ** 2
    f_gpt = 6 * n_gpt * t_gpt + 12 * g["n_layer"] * t_gpt ** 2 * d
    f_ad = 6 * n_ad * t_ad + 12 * a["n_layer"] * t_ad ** 2 * c
    return batch * (f_gpt + f_ad)
