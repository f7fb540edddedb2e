"""Speculative decode: a draft model proposes k tokens per cycle, the target
verifies them in one forward over the k positions.

The port of the JAX package's `spec_decode.py`. A cycle runs k draft decode
steps (`decode.decode_step_multi`, a position per row, on the draft's own
cache), then one target `forward_chunk` over [cur, d_1 .. d_{k-1}] at each
row's base position, which writes the chunk's rows with one
`append_kv` a layer and attends through the chunk kernels
(`ops/flash_chunk.py`). Greedy decoding (no seed) accepts the leading
drafts that equal the target's argmax, so the tokens are the target's own
greedy tokens for any draft; with a seed, Leviathan accept/reject
(`speculative_accept`) preserves the target's warped (temperature / top-k /
top-p) distribution. Each logical row advances by its own accepted count; a
finished row keeps cycling, its positions past the block, until the slowest
row finishes.

The JAX `while_loop` is a Python loop that reads one value from the device
per cycle (whether any row is unfinished); everything else stays on the
device. Random numbers come from a `torch.Generator` seeded from `seed`, so
sampled streams differ from the JAX package's (ROADMAP, "How the port is
checked"). Drafts are any model with the target's vocabulary and prefix
semantics: a smaller family member, or a quantized copy of the target
(`pipeline.ControlARPipeline.generate(spec_draft=...)`).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch import decode as dec
from controlar_tpu_torch.config import GPTConfig, find_multiple
from controlar_tpu_torch.generate import cfg_mix, prepare_inputs
from controlar_tpu_torch.models.gpt import GPT
from controlar_tpu_torch.ops.sampling import sample_from, top_k_top_p_filter


def forward_chunk(
    model: GPT,
    cfg: GPTConfig,
    caches: dec.Caches,
    tokens: Optional[torch.Tensor],
    pos: torch.Tensor,
    fused3: Optional[torch.Tensor] = None,
    col_mask_full: Optional[torch.Tensor] = None,
    control_strength=1.0,
    use_flash: bool = True,
    emb: Optional[torch.Tensor] = None,
    prefill_fusion: bool = False,
    rope_table: Optional[dec.Rope] = None,
):
    """K-token chunk forward with a base position per row: tokens (B, K), or
    None with emb (B, K, dim) pre-embedded rows; pos (B,) int32, the chunk
    occupying rows pos[b] .. pos[b] + K - 1. Returns (logits (B, K, V) f32,
    caches); the chunk's rows are written in place (`append_kv`, once a layer).

    Query j attends to the cache rows <= pos[b] + j and always to its own
    row, even where col_mask_full masks it (the diagonal exception, as in
    `prefill_flat`). Row b's K control rows are one slice of the fusion slab
    starting at pos[b] - cls_token_num + 1, with the start placed as the JAX
    package's `dynamic_slice_in_dim` places it: a negative start counts once
    from the end, then the start is clamped into [0, block_size - K], so a
    chunk that runs past the block reads rows shifted back, its valid
    positions included. prefill_fusion instead adds control row 0 on
    position cls_token_num - 1 only (the prefix semantics of
    `prefill_flat`). The JAX package's apply_fusion flag, which no caller
    sets, is left out."""
    h = model.tok_embeddings(tokens) if emb is None else emb
    b, k = h.shape[:2]
    dev = h.device
    if rope_table is None:
        rope_table = dec.rope_tables(model, cfg, dev)
    ar = torch.arange(k, device=dev)
    chunk_pos = pos.long()[:, None] + ar[None, :]  # (B, K)
    rope = dec._rope_at(rope_table, chunk_pos)

    control = None
    if fused3 is not None:
        if prefill_fusion:
            is_last = (chunk_pos == cfg.cls_token_num - 1)[..., None]

            def control(i):
                return torch.where(is_last, fused3[i][:, 0:1], 0)
        else:
            start = pos.long() - cfg.cls_token_num + 1
            start = torch.where(start < 0, start + cfg.block_size, start)
            start = torch.clamp(start, 0, cfg.block_size - k)
            rows = torch.arange(b, device=dev)[:, None]

            def control(i):
                return fused3[i][rows, start[:, None] + ar[None, :]]

    h = dec._decode_layers(model, cfg, caches, h, pos, rope, control, col_mask_full,
                           control_strength, use_flash, chunk=True)
    return dec._logits(model, cfg, h), caches


def speculative_accept(drafts: torch.Tensor, qprobs: torch.Tensor, pprobs: torch.Tensor,
                       generator: torch.Generator):
    """Leviathan et al. accept/reject for one verify cycle.

    drafts (B, K-1) sampled from the draft distributions qprobs (B, K-1, V);
    pprobs (B, K, V) the target's at the same positions. Returns (m (B,) the
    accepted drafts, tokens_row (B, K) with the accepted drafts before
    position m and the residual or bonus token at m, cur (B,) =
    tokens_row[:, m]). Draft j is accepted when u * q_j(d_j) < p_j(d_j) for
    u ~ U[0, 1) (strict: a draft outside the target's support is never
    accepted); at the first rejection the replacement is drawn from
    norm(max(p_m - q_m, 0)), falling back to p_m when that sums under 1e-9,
    and when every draft survives the bonus token comes from p_{K-1} (q
    taken as 0 there)."""
    b, km1 = drafts.shape
    dev = drafts.device
    pd = pprobs[:, :km1].gather(-1, drafts[..., None])[..., 0]
    qd = qprobs.gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((b, km1), generator=generator, device=dev)
    accept = u * qd < pd
    m = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # (B,) in [0, K-1]
    rows = torch.arange(b, device=dev)
    p_m = pprobs[rows, m]
    q_all = torch.cat([qprobs, torch.zeros_like(qprobs[:, :1])], dim=1)
    q_m = q_all[rows, m]
    res = torch.clamp(p_m - q_m, min=0.0)
    rsum = res.sum(dim=-1, keepdim=True)
    dist = torch.where(rsum > 1e-9, res / torch.clamp(rsum, min=1e-30), p_m)
    e_m = sample_from(torch.log(torch.clamp(dist, min=1e-30)), generator)
    cols = torch.arange(km1 + 1, device=dev)[None, :]
    tokens_row = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    tokens_row = torch.where(cols == m[:, None], e_m[:, None], tokens_row)
    return m, tokens_row, e_m


def _mix_rowwise(logits: torch.Tensor, n_row: torch.Tensor, cfg_scale: float,
                 cfg_interval: int) -> torch.Tensor:
    """CFG mix with the interval rule and a decode-step index per row.

    logits (2B, [K,] V); n_row (B,) finalized-token counts. Chunk position j
    is decode-loop step i = n_row + j - 1, and the guidance scale applies
    while i <= cfg_interval (as `generate.generate_tokens`). (The JAX
    package's offset argument is 0 at every call and is left out.)"""
    if cfg_scale <= 1.0:
        return logits
    cond, uncond = torch.chunk(logits, 2, dim=0)
    scale = cfg_scale
    if cfg_interval > -1:
        k = logits.shape[1] if logits.dim() == 3 else 1
        step = n_row[:, None] + torch.arange(k, device=logits.device)[None, :] - 1
        scale = torch.where(step > cfg_interval, 1.0, cfg_scale)
        scale = scale[:, :, None] if logits.dim() == 3 else scale[:, 0, None]
    return uncond + (cond - uncond) * scale


@torch.inference_mode()
def generate_tokens_spec(
    model: GPT,
    draft: GPT,
    cfg: GPTConfig,
    draft_cfg: GPTConfig,
    prefix_emb: torch.Tensor,
    draft_prefix_emb: torch.Tensor,
    fused3: Optional[torch.Tensor],
    draft_fused3: Optional[torch.Tensor],
    col_mask: Optional[torch.Tensor],
    control_strength=1.0,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    k_draft: int = 4,
    cfg_scale: float = 1.0,
    cfg_interval: int = -1,
    cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
    draft_cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
    use_flash: bool = False,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    on_step: Optional[Callable[[int], None]] = None,
):
    """Speculative decode of prepared inputs (CFG-doubled as for
    `generate.generate_tokens`). generator None: greedy; else speculative
    sampling with temperature / top-k / top-p on both sides. Both caches hold
    find_multiple(T_cls + max_new_tokens + k_draft + 64, 256 if use_flash
    else 8) rows, the JAX package's size. `on_step(i)` is called after cycle
    i. Returns (tokens (B, max_new_tokens) int64, accepted tokens per live
    row-cycle as a 0-d f32 tensor, the number of cycles)."""
    sample = generator is not None

    def warp(lg):
        return top_k_top_p_filter(lg / max(temperature, 1e-5), top_k, top_p)

    bc, t_cls, _ = prefix_emb.shape
    dev = prefix_emb.device
    use_cfg = cfg_scale > 1.0
    b = bc // 2 if use_cfg else bc
    n_new, k = max_new_tokens, k_draft
    s_max = find_multiple(t_cls + n_new + k + 64, 256 if use_flash else 8)
    caches_t = dec.init_flat_caches(cfg, bc, s_max, cache_dtype, dev)
    caches_d = dec.init_flat_caches(draft_cfg, bc, s_max, draft_cache_dtype, dev)
    rope_t = dec.rope_tables(model, cfg, dev)
    rope_d = dec.rope_tables(draft, draft_cfg, dev)

    logits0, caches_t = dec.prefill_flat(model, cfg, caches_t, prefix_emb, fused3, col_mask,
                                         control_strength, rope_t)
    _, caches_d = dec.prefill_flat(draft, draft_cfg, caches_d, draft_prefix_emb, draft_fused3,
                                   col_mask, control_strength, rope_d)
    mixed0 = cfg_mix(logits0, use_cfg, cfg_scale)
    tok0 = sample_from(warp(mixed0), generator) if sample else torch.argmax(mixed0, dim=-1)

    col_mask_full = None
    if col_mask is not None:
        col_mask_full = torch.cat(
            [col_mask, torch.ones((bc, s_max - t_cls), dtype=torch.bool, device=dev)], dim=1)

    def rep(x):
        return torch.cat([x, x]) if use_cfg else x

    out = torch.zeros((b, n_new + k), dtype=torch.long, device=dev)
    out[:, 0] = tok0
    cur = tok0
    n = torch.ones(b, dtype=torch.long, device=dev)  # finalized tokens per row
    acc_sum = torch.zeros((), device=dev)
    cyc_sum = torch.zeros((), device=dev)
    ar_k = torch.arange(k, device=dev)
    cycles = 0
    while bool((n < n_new).any()):  # the cycle's one read from the device
        pos0_r = rep(t_cls + n - 1).int()  # each row's chunk base position

        # draft k steps on its own cache, a position per row
        tok, drafts, qprobs = cur, [], []
        for j in range(k):
            logits, caches_d = dec.decode_step_multi(
                draft, draft_cfg, caches_d, rep(tok), pos0_r + j, draft_fused3,
                control_strength, use_flash=use_flash, col_mask_full=col_mask_full,
                rope_table=rope_d)
            mixed = _mix_rowwise(logits, n + j, cfg_scale, cfg_interval)
            if sample:
                warped = warp(mixed)
                tok = sample_from(warped, generator)
                qprobs.append(torch.softmax(warped, dim=-1))
            else:
                tok = torch.argmax(mixed, dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # (B, k): drafts[:, j] = d_{j+1}

        # verify: one target forward over [cur, d_1 .. d_{k-1}]
        chunk = torch.cat([cur[:, None], drafts[:, : k - 1]], dim=1)
        logits, caches_t = forward_chunk(
            model, cfg, caches_t, rep(chunk), pos0_r, fused3, col_mask_full, control_strength,
            use_flash=use_flash, rope_table=rope_t)
        mixed = _mix_rowwise(logits, n, cfg_scale, cfg_interval)
        if sample:
            pprobs = torch.softmax(warp(mixed), dim=-1)
            m, g, cur2 = speculative_accept(drafts[:, : k - 1],
                                            torch.stack(qprobs[: k - 1], dim=1), pprobs,
                                            generator)
        else:
            g = torch.argmax(mixed, dim=-1)  # (B, k)
            matches = drafts[:, : k - 1] == g[:, : k - 1]
            m = torch.cumprod(matches.long(), dim=1).sum(dim=1)  # (B,) in [0, k-1]
            cur2 = g.gather(1, m[:, None])[:, 0]

        done = n >= n_new
        w_off = torch.where(done, n_new, n)
        out.scatter_(1, w_off[:, None] + ar_k[None, :], g)
        cur = torch.where(done, cur, cur2)
        live = (~done).float()
        acc_sum += ((m + 1) * live).sum()
        cyc_sum += live.sum()
        n = torch.where(done, n, n + m + 1)
        if on_step is not None:
            on_step(cycles)
        cycles += 1
    return out[:, :n_new], acc_sum / torch.clamp(cyc_sum, min=1.0), cycles


@torch.inference_mode()
def generate_spec(
    model: GPT,
    cfg: GPTConfig,
    draft: GPT,
    draft_cfg: Optional[GPTConfig] = None,
    *,
    labels=None,
    caption_emb=None,
    emb_masks=None,
    adapter_features=None,
    max_new_tokens: int,
    k_draft: int = 4,
    cfg_scale: float = 1.0,
    cfg_interval: int = -1,
    control_strength: float = 1.0,
    cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
    draft_cache_dtype: Union[torch.dtype, str, None] = None,
    use_flash: Optional[bool] = None,
    return_stats: bool = False,
    seed: Optional[int] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    device="cuda",
    on_step: Optional[Callable[[int], None]] = None,
):
    """Speculative generate, with the arguments of `generate.generate`.

    draft is a quantized copy of the target or a smaller family member (pass
    its config as draft_cfg); draft_cache_dtype None takes cache_dtype. seed
    None decodes greedily (the target's own greedy tokens); a seed samples
    speculatively (Leviathan) from the warped target distribution.
    use_flash=None takes the kernels on the card when every head has its own
    K/V head; on the card use_flash=False is refused unless kv_heads !=
    n_head, a shape the attention kernels do not take. The rows go through
    the append kernels on the card either way. Runs on `device`; both models
    must already be there. Returns tokens (B, max_new_tokens) int64, and with
    return_stats a dict of accepted_per_cycle (accepted tokens per live
    row-cycle, in [1, k_draft]), k_draft and loop_iters (cycles)."""
    dev = resolve_device(device)
    check_on(model, dev)
    check_on(draft, dev)
    draft_cfg = draft_cfg or cfg
    if draft_cache_dtype is None:
        draft_cache_dtype = cache_dtype
    kernel_heads = cfg.kv_heads == cfg.n_head  # what the attention kernels take
    if use_flash is None:
        use_flash = dev.type == "cuda" and kernel_heads
    elif dev.type == "cuda" and kernel_heads and not use_flash:
        raise ValueError("use_flash=False on the card is only for kv_heads != n_head, "
                         "which the attention kernels do not take")
    use_cfg = cfg_scale > 1.0
    inputs = dict(labels=labels, caption_emb=caption_emb, emb_masks=emb_masks,
                  adapter_features=adapter_features)
    prefix, col_mask, fused3 = prepare_inputs(model, cfg, dev, use_cfg, **inputs)
    draft_prefix, _, draft_fused3 = prepare_inputs(draft, draft_cfg, dev, use_cfg, **inputs)
    generator = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    tokens, acc, cycles = generate_tokens_spec(
        model, draft, cfg, draft_cfg, prefix, draft_prefix, fused3, draft_fused3, col_mask,
        control_strength, generator, max_new_tokens=max_new_tokens, k_draft=k_draft,
        cfg_scale=cfg_scale, cfg_interval=cfg_interval, cache_dtype=cache_dtype,
        draft_cache_dtype=draft_cache_dtype, use_flash=use_flash, temperature=temperature,
        top_k=top_k, top_p=top_p, on_step=on_step)
    if return_stats:
        return tokens, {"accepted_per_cycle": acc.item(), "k_draft": k_draft,
                        "loop_iters": cycles}
    return tokens


@torch.inference_mode()
def prefill_chunked(
    model: GPT,
    cfg: GPTConfig,
    caches: dec.Caches,
    prefix_emb: torch.Tensor,
    fused3: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
    control_strength=1.0,
    *,
    chunk: int = 256,
    use_flash: bool = True,
):
    """Chunked prefill, in place of `decode.prefill_flat`: the prefix goes
    through `forward_chunk` in pieces of `chunk` rows, so a long prefix never
    forms a (T, T) score matrix. Returns (last-position logits (B, V) f32,
    caches)."""
    b, t, _ = prefix_emb.shape
    dev = prefix_emb.device
    s_max = dec.cache_seq_len(caches)
    col_mask_full = None
    if col_mask is not None:
        col_mask_full = torch.cat(
            [col_mask.bool(),
             torch.ones((b, s_max - col_mask.shape[1]), dtype=torch.bool, device=dev)], dim=1)
    rope = dec.rope_tables(model, cfg, dev)
    logits = None
    for c0 in range(0, t, chunk):
        logits, caches = forward_chunk(
            model, cfg, caches, None, torch.full((b,), c0, dtype=torch.int32, device=dev),
            fused3, col_mask_full, control_strength, use_flash=use_flash,
            emb=prefix_emb[:, c0:c0 + chunk], prefill_fusion=True, rope_table=rope)
    return logits[:, -1], caches
