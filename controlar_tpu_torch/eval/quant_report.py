"""Quantization accuracy gate: the bf16 model against its int8 / W4 copies,
by token agreement and logit divergence (the JAX package's
`eval/quant_report.py`).

Per mode (`int8`, `int8+kv8`, `w4`, `w4+kv8`, `w4+kv4`: the weights, then
the KV cache) on the c2i surface, with the model's own bf16 greedy rollout as
the reference trajectory:

- teacher_forced_agreement: the share of positions where the quantized
  model's argmax equals the bf16 model's, both conditioned on the same
  history (prefill, then one `spec_decode.forward_chunk` over the N - 1
  reference tokens); also the acceptance estimate of a quantized self-draft;
- max_rel_logit_err: max |q - ref| over the teacher-forced logits, over
  max |ref|;
- mean_prefix_survival / free_running_match: the quantized greedy rollout
  against the bf16 one (tokens until the first divergence, per row; the
  share of equal tokens);
- sampled_agreement: teacher-forced argmax of the warped logits (temperature,
  top-k) plus one shared Gumbel draw on both sides, the maximal coupling of
  the two sampling distributions; sampled_free_match / sampled_survival: the
  two sampled rollouts from one seed;
- pos_agree_thirds / pos_agree_min: teacher-forced agreement over the first,
  middle and last third of the positions, and at the worst position.

Ship threshold (`docs/quant_stress.md`): teacher-forced agreement >= 0.99
and sampled agreement >= 0.95 on trained weights.

Each mode quantizes its own deep copy of the model (`quant.quantize_gpt`,
which works in place) and frees it before the next. The Gumbel noise comes
from a `torch.Generator` seeded with GUMBEL_SEED, or is passed in as a
tensor; the sampled rollouts draw from `torch.Generator`s seeded with
SAMPLE_SEED, so they differ from the JAX package's at its equal seeds.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch import decode as dec
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import spec_decode
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.ops.sampling import top_k_top_p_filter
from controlar_tpu_torch.quant import quantize_gpt

MODES = ("int8", "int8+kv8", "w4", "w4+kv8", "w4+kv4")
GUMBEL_SEED, SAMPLE_SEED = 17, 7  # the JAX package's PRNGKey(17) and PRNGKey(7)
_CACHE = {"kv8": torch.int8, "kv4": "int4"}


@torch.inference_mode()
def teacher_forced_logits(model: gpt_model.GPT, cfg: GPTConfig, prefix_emb: torch.Tensor,
                          tokens: torch.Tensor, cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits (B, N, V) f32 at every position of tokens (B, N) given the
    prefix: the prefill, then one forward_chunk over tokens[:, :N - 1] (the
    chunk kernels on the card); logits j predicts token j. The cache holds
    ((T_cls + N + 72) // 8 + 1) * 8 rows, the JAX package's size."""
    b, n = tokens.shape
    t_cls = prefix_emb.shape[1]
    dev = prefix_emb.device
    s_max = ((t_cls + n + 72) // 8 + 1) * 8
    caches = dec.init_flat_caches(cfg, b, s_max, cache_dtype, dev)
    logits0, caches = dec.prefill_flat(model, cfg, caches, prefix_emb, None, None)
    pos = torch.full((b,), t_cls, dtype=torch.int32, device=dev)
    rest, _ = spec_decode.forward_chunk(model, cfg, caches, tokens[:, : n - 1], pos,
                                        use_flash=dev.type == "cuda")
    return torch.cat([logits0[:, None], rest], dim=1)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """-log(-log(u)), u uniform in [tiny, 1) (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _survival(m: np.ndarray) -> float:
    """Mean over rows of the tokens before the first mismatch."""
    return float(np.argmin(np.concatenate([m, np.zeros((m.shape[0], 1), bool)], axis=1),
                           axis=1).mean())


@torch.inference_mode()
def measure_quant_agreement(
    model: gpt_model.GPT,
    cfg: GPTConfig,
    *,
    labels=None,
    modes: Sequence[str] = ("int8", "int8+kv8", "w4", "w4+kv8"),
    max_new_tokens: Optional[int] = None,
    cfg_scale: float = 1.0,
    sample_temperature: float = 1.0,
    sample_top_k: int = 2000,
    gumbel: Optional[torch.Tensor] = None,
    device="cuda",
    on_mode: Optional[Callable[[str], None]] = None,
) -> Dict[str, Dict[str, object]]:
    """model: the bf16 (or fp32) GPT, unquantized, on `device` ('cuda'
    unless the caller asks for 'cpu'); it is left as it is. Returns {mode:
    metrics}. labels default to arange(4) % num_classes; cfg_scale 1.0
    scores the conditional branch alone. gumbel: the (B, N, V) noise of the
    sampled agreement, drawn from GUMBEL_SEED when None. on_mode(name), when
    given, is called after the bf16 reference ("bf16") and after each mode,
    so a caller can read the kernel launches of each part."""
    dev = resolve_device(device)
    check_on(model, dev)
    if cfg.model_type != "c2i":
        raise ValueError("the gate runs on the c2i surface")
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise ValueError(f"modes must be among {MODES}, got {bad}")
    n_new = max_new_tokens or cfg.block_size
    if labels is None:
        labels = np.arange(4) % max(cfg.num_classes, 1)
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    prefix = gpt_model.embed_prefix_c2i(model, labels)
    gen_kw = dict(labels=labels, max_new_tokens=n_new, cfg_scale=cfg_scale, device=dev)
    sample_kw = dict(sample_logits=True, temperature=sample_temperature, top_k=sample_top_k,
                     seed=SAMPLE_SEED)

    def sampled_argmax(logits):
        f = top_k_top_p_filter(logits.float() / max(sample_temperature, 1e-5),
                               top_k=sample_top_k)
        return torch.argmax(f + gumbel, dim=-1)

    ref_tokens = tgen.generate(model, cfg, sample_logits=False, **gen_kw)
    ref_logits = teacher_forced_logits(model, cfg, prefix, ref_tokens)
    ref_arg = torch.argmax(ref_logits, dim=-1)
    if gumbel is None:
        gen = torch.Generator(device=dev).manual_seed(GUMBEL_SEED)
        gumbel = gumbel_noise(ref_logits.shape, gen, dev)
    gumbel = torch.as_tensor(gumbel, device=dev, dtype=torch.float32)
    ref_samp = sampled_argmax(ref_logits)
    ref_roll = tgen.generate(model, cfg, **sample_kw, **gen_kw)
    denom = max(ref_logits.abs().max().item(), 1e-9)
    if on_mode is not None:
        on_mode("bf16")

    out: Dict[str, Dict[str, object]] = {}
    for mode in modes:
        wmode, _, kvmode = mode.partition("+")
        cache_dtype = _CACHE.get(kvmode, torch.bfloat16)
        qmodel = quantize_gpt(copy.deepcopy(model), cfg, wmode)
        q_logits = teacher_forced_logits(qmodel, cfg, prefix, ref_tokens, cache_dtype)
        hit = torch.argmax(q_logits, dim=-1) == ref_arg
        pos_agree = hit.float().mean(dim=0).cpu().numpy()  # (N,)
        third = max(len(pos_agree) // 3, 1)
        thirds = [float(pos_agree[i * third:(i + 1) * third or None].mean()) for i in range(3)]
        q_tokens = tgen.generate(qmodel, cfg, sample_logits=False, cache_dtype=cache_dtype,
                                 **gen_kw)
        q_roll = tgen.generate(qmodel, cfg, cache_dtype=cache_dtype, **sample_kw, **gen_kw)
        eq = (q_tokens == ref_tokens).cpu().numpy()
        eq_s = (q_roll == ref_roll).cpu().numpy()
        out[mode] = {
            "teacher_forced_agreement": hit.float().mean().item(),
            "max_rel_logit_err": (q_logits - ref_logits).abs().max().item() / denom,
            "mean_prefix_survival": _survival(eq),
            "free_running_match": float(eq.mean()),
            "sampled_agreement": (sampled_argmax(q_logits) == ref_samp).float().mean().item(),
            "sampled_free_match": float(eq_s.mean()),
            "sampled_survival": _survival(eq_s),
            "pos_agree_thirds": thirds,
            "pos_agree_min": float(pos_agree.min()),
        }
        del qmodel, q_logits, q_tokens, q_roll  # free before the next mode
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if on_mode is not None:
            on_mode(mode)
    return out


def format_report(report: Dict[str, Dict[str, object]]) -> str:
    lines = ["mode     tf-agree  samp-agree  logit-rel-err  prefix-surv"
             "  free-match  samp-match  pos-thirds"]
    for mode, m in report.items():
        thirds = "/".join(f"{x:.2f}" for x in m.get("pos_agree_thirds", []))
        lines.append(
            f"{mode:8s} {m['teacher_forced_agreement']:8.3f} "
            f"{m.get('sampled_agreement', float('nan')):10.3f} "
            f"{m['max_rel_logit_err']:13.4f} "
            f"{m['mean_prefix_survival']:11.1f} "
            f"{m['free_running_match']:10.3f} "
            f"{m.get('sampled_free_match', float('nan')):10.3f}  {thirds}")
    return "\n".join(lines)
