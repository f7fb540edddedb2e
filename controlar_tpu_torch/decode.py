"""Decode engine: per-layer flat KV caches and the flash-decode kernels.

Each layer's cache is one (B, S, 2*H*D) tensor of interleaved [k | v] rows,
the JAX package's layout, so the kernel reads a row's k and v from one slab,
or, for a quantized cache, a dict as in the JAX package:

- int8 (`cache_dtype=torch.int8`): {"kv": (B, S, 2*H*D) int8, "s": (B, S,
  2*H) f32 per-head scales [k | v]}; attention runs
  `flash_decode_attention_q8`;
- int4 (`cache_dtype="int4"`; PyTorch has no usable int4 type):
  {"kv4": (B, S, 2 * H*D/2) int8 nibble carriers, "s": as above}; attention
  runs `flash_decode_attention_q4`, in split-rope layout for a split model.

Scales and int4 rows are unpadded (the JAX package pads both to 128 lanes
for the TPU). Unlike the JAX package, which returns new cache arrays, the
port writes the new rows into the cache tensors in place and returns the
same list.

The stacked cache (`init_stacked_caches`, the JAX package's `kv_stacked`)
holds every layer in one tensor per stream: a (L, B, S, 2*KV*D) tensor, or
the int8 / int4 dict of (L, B, S, ...) tensors. A decode step over it
scores each layer's new row, the in-flight row, from an operand of the
stacked attention kernels (`ops/flash_decode_stacked.py`) and writes all L
layers' rows at the end of the step: each layer's rows are quantized into
the step's in-flight rows by `append_kv`, and one `append_stacked` writes
them all into the stack (on the card one launch a layer and one a step).
The prefill writes each layer's rows through a view of the stack.

Decode attention runs the kernels when `use_flash` (on the card: CUDA,
reading only rows <= pos), else a masked einsum over the whole (dequantized)
slab. `decode_step_flat` decodes every row at one position (the generation
loop); `decode_step_multi` at a position per row (the serving engine and
the speculative draft). Both, and `spec_decode.forward_chunk` (T query rows
per batch row, the chunk kernels), run one layer loop (`_decode_layers`),
which writes a layer's new k and v rows into a per-layer cache with one
`append_kv` (on the card one launch that quantizes the rows and writes
every stream). Quantized weights (`quant.W8Linear`, `quant.W4Linear`)
are called where the linears are; a layer with a fused W4 `w13` runs the fused FFN
kernel on the card (`ffn`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models.gpt import (
    GPT,
    _fusion_gates,
    _logits,
    _qkv,
    attend_masked,
    make_rope_table,
)
from controlar_tpu_torch.ops.cache_append import (
    Cache,
    append_kv,
    append_stacked,
    cache_streams,
    inflight_layer,
    stacked_inflight,
    stream_list,
)
from controlar_tpu_torch.ops.flash_chunk import (
    flash_chunk_attention,
    flash_chunk_attention_q4,
    flash_chunk_attention_q8,
)
from controlar_tpu_torch.ops.flash_decode import (
    INT4,  # cache_dtype of the nibble-packed cache
    flash_decode_attention,
    flash_decode_attention_q4,
    flash_decode_attention_q8,
)
from controlar_tpu_torch.ops.flash_decode_stacked import (
    flash_stacked,
    flash_stacked_q4,
    flash_stacked_q8,
    layer_with_row,
)
from controlar_tpu_torch.ops.norms import rms_norm
from controlar_tpu_torch.ops.rope import apply_rope_split, make_split_rope_tables
from controlar_tpu_torch.ops.w4_matmul import w4_ffn, w4_ffn_fits
from controlar_tpu_torch.quant import (
    dequantize_kv4_slab,
    dequantize_kv_slab,
    W4Linear,
    is_split,
)
from controlar_tpu_torch.spans import span

Caches = Union[List[Cache], Cache]  # per-layer caches, or one stacked cache
Rope = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _zeros_cache(cfg: GPTConfig, lead: Tuple[int, ...], dtype: Union[torch.dtype, str],
                 device) -> Cache:
    """A zeroed cache whose streams have leading dims `lead`: a (*lead,
    2*KV*D) tensor of a floating dtype, or the int8 (`torch.int8`) or int4
    (`"int4"`) dict."""
    hd = cfg.kv_heads * cfg.head_dim

    def zeros(width, dt):
        return torch.zeros((*lead, width), dtype=dt, device=device)

    if dtype == torch.int8:
        return {"kv": zeros(2 * hd, torch.int8), "s": zeros(2 * cfg.kv_heads, torch.float32)}
    if dtype == INT4:
        return {"kv4": zeros(hd, torch.int8), "s": zeros(2 * cfg.kv_heads, torch.float32)}
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise ValueError(f"cache dtype must be floating, torch.int8 or 'int4', got {dtype!r}")
    return zeros(2 * hd, dtype)


def init_flat_caches(cfg: GPTConfig, batch: int, max_seq: int,
                     dtype: Union[torch.dtype, str] = torch.bfloat16, device="cpu") -> Caches:
    """One zeroed cache per layer: a (batch, max_seq, 2*KV*D) tensor of a
    floating dtype, or the int8 (`torch.int8`) or int4 (`"int4"`) dict."""
    return [_zeros_cache(cfg, (batch, max_seq), dtype, device) for _ in range(cfg.n_layer)]


def init_stacked_caches(cfg: GPTConfig, batch: int, max_seq: int,
                        dtype: Union[torch.dtype, str] = torch.bfloat16, device="cpu") -> Cache:
    """The zeroed stacked cache: a (n_layer, batch, max_seq, 2*KV*D) tensor,
    or the int8 or int4 dict of (n_layer, batch, max_seq, ...) tensors."""
    return _zeros_cache(cfg, (cfg.n_layer, batch, max_seq), dtype, device)


def is_stacked_caches(caches: Caches) -> bool:
    return not isinstance(caches, (list, tuple))


def _first_stream(cache: Cache) -> torch.Tensor:
    return cache["s"] if isinstance(cache, dict) else cache


def cache_seq_len(caches: Caches) -> int:
    if is_stacked_caches(caches):
        return _first_stream(caches).shape[2]
    return _first_stream(caches[0]).shape[1]


def _layer_view(caches: Caches, l: int) -> Cache:
    """Layer l's cache: a view into a stacked cache."""
    if isinstance(caches, dict):
        return {k: v[l] for k, v in caches.items()}
    return caches[l]


def rope_tables(model: GPT, cfg: GPTConfig, device) -> Rope:
    """The model's RoPE: the (T, D/2, 2) table, or for a split-rope model
    the full-width (cos, sin) rows, each (T, (H + KV) * D)."""
    table = make_rope_table(cfg).to(device)
    if is_split(model):
        return make_split_rope_tables(table, cfg.n_head, cfg.kv_heads, cfg.head_dim)
    return table


def _rope_rows(rope: Rope, start: int, stop: int) -> Rope:
    if isinstance(rope, tuple):
        return tuple(t[start:stop] for t in rope)
    return rope[start:stop]


def _qkv_for(lp, cfg: GPTConfig, x: torch.Tensor, rope: Rope):
    """Project and rotate under either layout: q (B,T,H,D), k/v (B,T,KV,D).
    In split layout only the order of dims inside each head differs, which
    cancels in q.k and in the permuted wo."""
    if not isinstance(rope, tuple):
        return _qkv(lp, cfg, x, rope)
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    qkv = lp.wqkv(x)
    qk = apply_rope_split(qkv[..., : (nh + nkv) * hd], *rope, hd)
    q = qk[..., : nh * hd].reshape(b, t, nh, hd)
    k = qk[..., nh * hd:].reshape(b, t, nkv, hd)
    return q, k, qkv[..., (nh + nkv) * hd:].reshape(b, t, nkv, hd)


def _write_rows(cache: Cache, kv_rows: torch.Tensor, start: int, kv_heads: int,
                split: bool) -> None:
    """cache[:, start:start+T] = kv_rows (B, T, 2*KV*D), quantized for a
    quantized cache; in place."""
    stop = start + kv_rows.shape[1]
    for dst, src in cache_streams(cache, kv_rows, kv_heads, split):
        dst[:, start:stop] = src


def _layer_with_rows(caches: Cache, l: int, rows: List[torch.Tensor], pos) -> Cache:
    """A copy of layer l of a stacked cache with the in-flight rows (B, W),
    one per stream, written at pos (an int, or a (B,) tensor): the slab the
    plain route attends over, as the JAX package's fallback builds it."""
    if isinstance(caches, dict):
        key = "kv4" if "kv4" in caches else "kv"
        return {key: layer_with_row(caches[key], rows[0], l, pos),
                "s": layer_with_row(caches["s"], rows[1], l, pos)}
    return layer_with_row(caches, rows[0], l, pos)


def _dequant_slab(cache: Dict[str, torch.Tensor], cfg: GPTConfig, dtype, split: bool = False):
    if "kv4" in cache:
        return dequantize_kv4_slab(cache["kv4"], cache["s"], cfg.kv_heads, cfg.head_dim,
                                   dtype, split=split)
    return dequantize_kv_slab(cache["kv"], cache["s"], cfg.kv_heads, dtype)


def _flash_attn(q: torch.Tensor, cache: Cache, pos, col_bias, cfg: GPTConfig, split: bool,
                chunk: bool) -> torch.Tensor:
    """Attention through the kernels for the cache's format: q (B, T, H, D)
    -> (B, T, H*D). A decode step (chunk=False, T = 1) runs the decode
    kernels, a chunk the chunk kernels."""
    b, t = q.shape[:2]
    hd = cfg.n_head * cfg.head_dim
    # split-rope q is a slice of [q|k]: the kernels take it contiguous
    q = (q.reshape(b, t, hd) if chunk else q.reshape(b, hd)).contiguous()
    kw = dict(n_head=cfg.n_head)
    if not isinstance(cache, dict):
        fn, args = (flash_chunk_attention if chunk else flash_decode_attention), (cache,)
    elif "kv4" in cache:
        fn = flash_chunk_attention_q4 if chunk else flash_decode_attention_q4
        args = (cache["kv4"], cache["s"])
        kw.update(head_dim=cfg.head_dim, split=split)
    else:
        fn = flash_chunk_attention_q8 if chunk else flash_decode_attention_q8
        args = (cache["kv"], cache["s"])
    return fn(q, *args, pos, col_bias, **kw).reshape(b, t, hd)


def _flash_stacked_attn(q: torch.Tensor, caches: Cache, rows: List[torch.Tensor], l: int,
                        pos, col_bias, cfg: GPTConfig, split: bool) -> torch.Tensor:
    """Attention of q (B, 1, H, D) over layer l of a stacked cache and the
    in-flight rows (one per stream) through the stacked kernels -> (B, 1, H*D)."""
    b = q.shape[0]
    hd = cfg.n_head * cfg.head_dim
    q = q.reshape(b, hd).contiguous()
    if not isinstance(caches, dict):
        out = flash_stacked(q, rows[0], caches, l, pos, col_bias, n_head=cfg.n_head)
    elif "kv4" in caches:
        out = flash_stacked_q4(q, *rows, caches["kv4"], caches["s"], l, pos, col_bias,
                               n_head=cfg.n_head, head_dim=cfg.head_dim, split=split)
    else:
        out = flash_stacked_q8(q, *rows, caches["kv"], caches["s"], l, pos, col_bias,
                               n_head=cfg.n_head)
    return out.reshape(b, 1, hd)


def ffn(lp, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN. A fused `w13` = [w1 | w3] layer runs one product for both
    halves; when w13 and w2 are W4 and the shapes pass `w4_ffn_fits`, the
    card runs the whole FFN as the one `w4_ffn` kernel."""
    if not hasattr(lp, "w13"):
        return lp.w2(F.silu(lp.w1(x)) * lp.w3(x))
    if isinstance(lp.w13, W4Linear) and isinstance(lp.w2, W4Linear):
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda and w4_ffn_fits(lp.w13.q4, lp.w13.s, lp.w2.q4, lp.w2.s, *x2.shape):
            out = w4_ffn(x2, lp.w13.q4, lp.w13.s, lp.w2.q4, lp.w2.s, out_dtype=x.dtype)
            return out.reshape(*x.shape[:-1], out.shape[-1])
    h1, h3 = torch.chunk(lp.w13(x), 2, dim=-1)
    return lp.w2(F.silu(h1) * h3)


def _fuse(fused3_l: torch.Tensor, control_strength, dtype: torch.dtype) -> torch.Tensor:
    return (control_strength * fused3_l.float()).to(dtype)


def prefill_flat(
    model: GPT,
    cfg: GPTConfig,
    caches: Caches,
    prefix_emb: torch.Tensor,
    fused3: Optional[torch.Tensor],
    col_mask: Optional[torch.Tensor],
    control_strength=1.0,
    rope_table: Optional[Rope] = None,
) -> Tuple[torch.Tensor, Caches]:
    """Prefill the prefix; returns (last-position logits (B, V) f32, caches).

    Only the last prefix position receives control token 0. With a column
    mask, a position sees the columns that are causal AND (unmasked OR its
    own), so fully masked padding rows still attend to themselves. Attention
    here uses the unquantized k and v, as in the JAX package. caches may be
    per-layer or stacked; either gets the same rows.
    rope_table: `rope_tables(model, cfg, device)`, made here when None."""
    b, t, _ = prefix_emb.shape
    dev = prefix_emb.device
    gate, fidx = _fusion_gates(cfg)
    if rope_table is None:
        rope_table = rope_tables(model, cfg, dev)
    rope = _rope_rows(rope_table, 0, t)
    split = isinstance(rope, tuple)
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(t, device=dev)[None, :]
    causal = rows >= cols
    if col_mask is not None:
        m = causal[None] & (col_mask[:, None, :] | (rows == cols)[None])
    else:
        m = causal[None]
    mask = m[:, None]  # (B|1, 1, T, T)

    hd = cfg.n_head * cfg.head_dim
    h = prefix_emb
    for l, lp in enumerate(model.layers):
        if fused3 is not None and gate[l] > 0:
            add = _fuse(fused3[fidx[l]][:, 0:1], control_strength, h.dtype)
            h = torch.cat([h[:, :-1], h[:, -1:] + add], dim=1)
        x = rms_norm(h, lp.attention_norm, cfg.norm_eps)
        q, k, v = _qkv_for(lp, cfg, x, rope)
        _write_rows(_layer_view(caches, l),
                    torch.cat([k.reshape(b, t, hd), v.reshape(b, t, hd)], dim=-1),
                    0, cfg.kv_heads, split)
        h = h + lp.wo(attend_masked(q, k, v, mask))
        h = h + ffn(lp, rms_norm(h, lp.ffn_norm, cfg.norm_eps))
    return _logits(model, cfg, h[:, -1]), caches


def _decode_layers(model: GPT, cfg: GPTConfig, caches: Caches, h: torch.Tensor,
                   pos: Union[int, torch.Tensor], rope: Rope, control,
                   col_mask_full: Optional[torch.Tensor], control_strength,
                   use_flash: bool, chunk: bool = False) -> torch.Tensor:
    """The layer loop of the decode steps and of the chunk forward; returns
    the final hidden state (B, T, dim).

    h (B, T, dim) holds the embedded input rows: one per batch row for a
    decode step, the chunk's T rows for a chunk (chunk=True), row j at
    position pos[b] + j. pos is one position for every row, or a (B,) int32
    tensor of a position per row; rope holds the rows' RoPE; control(f) ->
    (B, T | 1, dim) picks the rows' control tokens from fusion slab f (None:
    no control). A layer's new k and v rows go into its cache at pos[b] + j
    through one `append_kv`, before its attention. Row j of a chunk attends
    to the cache rows <= pos[b] + j, and the column mask is not applied on
    its own row (the diagonal exception of the chunk kernels); a decode step
    applies the mask everywhere, as the JAX package's decode steps do.

    On a stacked cache (a decode step, T = 1), layer l's new rows go through
    the same `append_kv` into the step's in-flight rows (`stacked_inflight`,
    (L, B, W) per stream) at layer l, and layer l attends to its rows <
    pos[b] and that in-flight row: through the stacked kernels, or over a
    copy of the layer with the row written. After the last layer one
    `append_stacked` stores every layer's rows of every stream (the rows,
    and a quantized cache's scales) at pos[b].

    Each layer's control add, attention (its norm through `wo` and the
    residual, `append_kv` and the attention kernel included) and FFN (its
    norm through the residual) are the profiler spans `decode.fuse`,
    `decode.attn` and `decode.ffn` (`spans.span`)."""
    b, t = h.shape[:2]
    dev = h.device
    kvd = cfg.kv_heads * cfg.head_dim
    split = isinstance(rope, tuple)
    gate, fidx = _fusion_gates(cfg)
    s_max = cache_seq_len(caches)
    stacked = is_stacked_caches(caches)
    if stacked and (t != 1 or _first_stream(caches).shape[0] != cfg.n_layer):
        raise ValueError(f"a stacked cache takes one query row per batch row and "
                         f"{cfg.n_layer} layers, got T = {t} and the cache "
                         f"{tuple(_first_stream(caches).shape)}")
    # stacked: this step's new rows of every layer, (L, B, W) per stream
    inflight = stacked_inflight(caches, b) if stacked else None
    col_bias = None
    if use_flash:
        if col_mask_full is not None:
            col_bias = torch.where(col_mask_full, 0.0, -1e9).float()
    else:
        last = pos[:, None] if isinstance(pos, torch.Tensor) else pos
        own = (torch.arange(t, device=dev)[None, :] + last)[..., None]  # (B|1, T, 1)
        cols = torch.arange(s_max, device=dev)[None, None, :]
        allowed = cols <= own
        if col_mask_full is not None:
            keep = col_mask_full[:, None, :]
            allowed = allowed & ((keep | (cols == own)) if chunk else keep)
        mask = allowed[:, None]  # (B|1, 1, T, S)

    for l, lp in enumerate(model.layers):
        if control is not None and gate[l] > 0:
            with span("decode.fuse"):
                h = h + _fuse(control(fidx[l]), control_strength, h.dtype)
        with span("decode.attn"):
            x = rms_norm(h, lp.attention_norm, cfg.norm_eps)
            q, k, v = _qkv_for(lp, cfg, x, rope)  # (B, T, H, D), (B, T, KV, D)
            kr, vr = k.reshape(b, t, kvd), v.reshape(b, t, kvd)
            if stacked:  # layer l's in-flight rows, written as a (B, 1, W) cache at row 0
                append_kv(inflight_layer(inflight, l), kr, vr, 0, kv_heads=cfg.kv_heads,
                          split=split)
                rows = [x[l] for x in stream_list(inflight)]
                cache = None if use_flash else _layer_with_rows(caches, l, rows, pos)
            else:
                cache = caches[l]
                append_kv(cache, kr, vr, pos, kv_heads=cfg.kv_heads, split=split)
            if use_flash and stacked:
                attn = _flash_stacked_attn(q, caches, rows, l, pos, col_bias, cfg,
                                           split).to(h.dtype)
            elif use_flash:
                attn = _flash_attn(q, cache, pos, col_bias, cfg, split, chunk).to(h.dtype)
            else:
                slab = (_dequant_slab(cache, cfg, h.dtype, split) if isinstance(cache, dict)
                        else cache)
                kl = slab[:, :, :kvd].reshape(b, s_max, cfg.kv_heads, cfg.head_dim)
                vl = slab[:, :, kvd:].reshape(b, s_max, cfg.kv_heads, cfg.head_dim)
                attn = attend_masked(q, kl, vl, mask)
            h = h + lp.wo(attn)
        with span("decode.ffn"):
            h = h + ffn(lp, rms_norm(h, lp.ffn_norm, cfg.norm_eps))
    if stacked:
        append_stacked(caches, inflight, pos)
    return h


def decode_step_flat(
    model: GPT,
    cfg: GPTConfig,
    caches: Caches,
    token: torch.Tensor,
    pos: int,
    fused3: Optional[torch.Tensor],
    col_mask_full: Optional[torch.Tensor],
    control_strength=1.0,
    use_flash: bool = True,
    rope_table: Optional[Rope] = None,
) -> Tuple[torch.Tensor, Caches]:
    """One decode step at position pos for token (B,); returns (logits (B, V)
    f32, caches). Position pos receives control token pos - cls_token_num + 1.
    On a stacked cache every layer's row is written at the end of the step
    with one `append_stacked`."""
    if rope_table is None:
        rope_table = rope_tables(model, cfg, token.device)
    rope = _rope_rows(rope_table, pos, pos + 1)
    f = pos - cfg.cls_token_num + 1
    control = None if fused3 is None else (lambda i: fused3[i][:, f:f + 1])
    h = _decode_layers(model, cfg, caches, model.tok_embeddings(token)[:, None, :], pos, rope,
                       control, col_mask_full, control_strength, use_flash)
    with span("decode.logits"):
        logits = _logits(model, cfg, h[:, -1])
    return logits, caches


def _rope_at(rope: Rope, pos: torch.Tensor) -> Rope:
    """RoPE rows at a position per row, pos (B,), or per row and chunk
    position, pos (B, T): (B, T, D/2, 2), or for split rope (cos, sin), each
    (B, T, (H + KV) * D), with T = 1 for pos (B,). A position past the table
    takes its last row, as the JAX package's gather clamps an index (the
    rows of a finished sequence in speculative decode run past the block)."""
    idx = pos.long()
    if idx.dim() == 1:
        idx = idx[:, None]

    def rows(table):
        return table[idx.clamp(0, table.shape[0] - 1)]

    if isinstance(rope, tuple):
        return tuple(rows(t) for t in rope)
    return rows(rope)


def decode_step_multi(
    model: GPT,
    cfg: GPTConfig,
    caches: Caches,
    token: torch.Tensor,
    pos: torch.Tensor,
    fused3: Optional[torch.Tensor] = None,
    control_strength=1.0,
    use_flash: bool = True,
    col_mask_full: Optional[torch.Tensor] = None,
    rope_table: Optional[Rope] = None,
) -> Tuple[torch.Tensor, Caches]:
    """One decode step with a position per row: token (B,), pos (B,) int32
    on the device (the serving engine's step, each slot at its own depth).
    Returns (logits (B, V) f32, caches); the rows are written in place.

    control_strength is a float or a (B, 1, 1) tensor. Row b receives control
    token f = pos[b] - cls_token_num + 1, which leaves the block on a frozen
    slot at the last position (f = block_size) and on a never-admitted slot
    at position 0 (f = 1 - cls_token_num); as in the JAX package's dynamic
    slice, a negative f counts once from the end and f is then clamped to
    [0, block_size - 1] (the rows of such slots are discarded). The rows go
    through `append_kv` (its kernel on the card); attention through
    the flash kernels with the column bias of col_mask_full under use_flash,
    else the masked einsum.

    On a stacked cache the positions are first raised to at least 1, as the
    JAX package does: a never-admitted slot at position 0 then takes its
    RoPE, control row and written row at position 1 (the engine overwrites
    the slot at admission). All layers' rows are written at the end of the
    step with one `append_stacked`."""
    stacked = is_stacked_caches(caches)
    if stacked:
        pos = torch.clamp(pos, min=1)
    dev = token.device
    if rope_table is None:
        rope_table = rope_tables(model, cfg, dev)
    rope = _rope_at(rope_table, pos)
    f = pos.long() - cfg.cls_token_num + 1
    # the JAX package's dynamic slice: a negative start counts once from the
    # end, then the start is clamped into the block
    f = torch.clamp(torch.where(f < 0, f + cfg.block_size, f), 0, cfg.block_size - 1)
    rows_idx = torch.arange(token.shape[0], device=dev)
    control = None if fused3 is None else (lambda i: fused3[i][rows_idx, f][:, None])
    h = _decode_layers(model, cfg, caches, model.tok_embeddings(token)[:, None, :], pos, rope,
                       control, col_mask_full, control_strength, use_flash)
    return _logits(model, cfg, h[:, -1]), caches
