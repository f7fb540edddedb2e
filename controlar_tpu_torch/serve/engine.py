"""Continuous-batching serving engine over per-slot decode steps.

The port of the JAX package's `serve/engine.py`. Image generation has
fixed-length sequences, so each slot owns a static slab of the KV cache;
the scheduler runs in-process and the device state stays on the device.

Layout: `max_slots` requests ride a 2*max_slots batch (rows [0, slots) carry
the conditional branch, rows [slots, 2*slots) the unconditional one; the
engine mixes them `uncond + (cond - uncond) * cfg_scale` per slot). Each slot
advances at its own position through `decode.decode_step_multi`. The decode
batch is always all 2*max_slots rows, never only the active slots: a row's
logits then never depend on its neighbours (the matmul libraries may choose
another algorithm for another batch), and a frozen slot rewrites the bytes
it wrote before.

Scheduling (one `step()`):
1. Group admission: every waiting request that has a free slot is
   prefilled in one batch of 2K rows [cond; uncond] into a small cache, its
   first token sampled, and its caches and slot state copied into the slot
   rows with indexed copies (on dim 1 of the stacked cache, `kv_stacked`).
   The JAX package pads a group to a power of two only to bound XLA
   compiles; the port admits the group as it is, which changes no
   request's tokens.
2. A decode quantum of q steps (`quantum`, or the bucket `_pick_quantum`
   picks): q calls of `decode_step_multi` with no host sync inside. A slot
   advances while `active & (pos < cls_token_num + block_size - 1)`; a
   completed slot freezes, re-decodes its last token at its last position
   and the host drops the surplus samples.
3. The host collects finished sequences and refills the slots.

With `overlap_admission` the host never waits for a quantum's tokens: slot
completion depends only on lengths, so it is known when the quantum is
enqueued; each quantum's tokens are copied to pinned host memory without
blocking, beside a CUDA event, and collected once `event.query()` says they
have landed (at most `overlap_depth` quanta in flight). Inputs go to the
card through pinned memory without a sync as well.

Sampling is reproducible per request: token k of a request is drawn with
`ops.sampling.sample_keyed` from noise keyed on (seed, k), whatever slot,
group or schedule it rides in.

Engine state is updated in place across `step()` calls, so it is created
and updated under `torch.inference_mode()`.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch import decode as dec
from controlar_tpu_torch.config import GPTConfig, find_multiple
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.ops.sampling import sample_keyed


def _streams(cache: dec.Cache) -> List[torch.Tensor]:
    """A layer cache's tensors, or a stacked cache's: the slab, or the
    quantized rows and scales."""
    return list(cache.values()) if isinstance(cache, dict) else [cache]


@dataclasses.dataclass
class Request:
    request_id: int
    label: Optional[int] = None          # c2i
    caption_emb: Any = None              # t2i (T_cls, caption_dim), array or tensor
    emb_mask: Any = None                 # t2i (T_cls,) left-pad mask
    adapter_features: Any = None         # (block_size, adapter_dim), array or tensor
    cfg_scale: float = 4.0
    control_strength: float = 1.0
    seed: int = 0
    # filled by the engine
    tokens: Optional[np.ndarray] = None
    t_submit: Optional[float] = None     # time.perf_counter() at add_request
    t_done: Optional[float] = None       # when the last token reached the host


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's `ServeConfig` without `compilation_cache_dir`,
    which is XLA's: nothing is compiled here.

    quantum_buckets: shorter quanta `_pick_quantum` may choose; None keeps
    the one fixed quantum. quantum_policy "early_exit" takes the smallest
    bucket covering the earliest-finishing slot; "occupancy" also shrinks
    the quantum with slot occupancy. cache_dtype: a floating dtype,
    torch.int8 or "int4". use_flash: the attention kernels, else the masked
    einsum; None takes the kernels on the card when every head has its own
    K/V head (kv_heads == n_head). On the card use_flash=False is refused
    unless kv_heads != n_head, a shape the attention kernels do not take;
    the row append runs its kernel on the card either way. kv_stacked=True
    keeps the stacked cache (`decode.init_stacked_caches`): a step runs the
    stacked attention kernels and writes every layer's rows with one
    `append_stacked` (`decode._decode_layers`)."""
    max_slots: int = 8
    quantum: int = 64
    quantum_buckets: Optional[tuple] = None
    quantum_policy: str = "early_exit"
    temperature: float = 1.0
    top_k: int = 2000
    top_p: float = 1.0
    greedy: bool = False
    cache_dtype: Any = torch.bfloat16
    use_flash: Optional[bool] = None
    kv_stacked: bool = False
    overlap_admission: bool = False
    overlap_depth: int = 2


class ServeEngine:
    """Serve `model` (a GPT, quantized beforehand by `quant.quantize_gpt` or
    not) on `device` ('cuda' unless the caller asks for 'cpu')."""

    def __init__(self, model: gpt_model.GPT, cfg: GPTConfig,
                 serve_cfg: Optional[ServeConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        check_on(model, self.device)
        # copy: never mutate a caller's (or a shared default) config
        scfg = dataclasses.replace(serve_cfg or ServeConfig())
        kernel_heads = cfg.kv_heads == cfg.n_head  # what the attention kernels take
        if scfg.use_flash is None:
            scfg.use_flash = self.device.type == "cuda" and kernel_heads
        elif self.device.type == "cuda" and kernel_heads and not scfg.use_flash:
            raise ValueError("use_flash=False on the card is only for kv_heads != n_head, "
                             "which the attention kernels do not take")
        self.model, self.cfg, self.scfg = model, cfg, scfg
        self.dtype = gpt_model.param_dtype(model)
        n = scfg.max_slots
        self.s_max = find_multiple(cfg.cls_token_num + cfg.block_size,
                                   256 if scfg.use_flash else 8)
        with torch.inference_mode():
            dev = self.device
            self.rope = dec.rope_tables(model, cfg, dev)
            self.caches = self._init_caches(2 * n)
            # control rows in bf16, as the JAX engine keeps them
            self.fused = torch.zeros((cfg.n_fusion_points, 2 * n, cfg.block_size, cfg.dim),
                                     dtype=torch.bfloat16, device=dev)
            self.pos = torch.zeros(2 * n, dtype=torch.int32, device=dev)
            self.cur_tok = torch.zeros(2 * n, dtype=torch.int64, device=dev)
            self.col_mask = torch.ones((2 * n, self.s_max), dtype=torch.bool, device=dev)
            self.cfg_scales = torch.ones(n, dtype=torch.float32, device=dev)
            self.strengths = torch.ones(n, dtype=torch.float32, device=dev)
            self.seeds = torch.zeros(n, dtype=torch.int64, device=dev)
        self.active = np.zeros((n,), bool)
        self.emitted = np.zeros((n,), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n
        self.outputs: Dict[int, List[int]] = {}
        self.waiting: "collections.deque[Request]" = collections.deque()
        self.finished: List[Request] = []
        # overlapped admission: (kind, host tensor, event or None, meta) in
        # enqueue order, collected lazily (see _drain)
        self._inflight: "collections.deque" = collections.deque()
        # device-step accounting: slot_steps counts every (slot, step) the
        # device computed; useful_steps those that emitted a kept token.
        # 1 - useful/slot = combined empty-slot + frozen-tail waste.
        self.stats = {"slot_steps": 0, "useful_steps": 0}

    def _init_caches(self, batch: int):
        init = dec.init_stacked_caches if self.scfg.kv_stacked else dec.init_flat_caches
        return init(self.cfg, batch, self.s_max, self.scfg.cache_dtype, self.device)

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.waiting.append(req)

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or bool(self.active.any()) or bool(self._inflight)

    # ------------------------------------------------------------------
    def _to_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Host data or a tensor -> a tensor on the engine's device; host data
        goes through pinned memory without a sync."""
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(self.device, dtype)
        t = torch.as_tensor(x, dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host(self, t: torch.Tensor):
        """-> (host tensor, CUDA event or None); the copy does not block."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _sample(self, logits: torch.Tensor, seeds: torch.Tensor,
                tok_idx: torch.Tensor) -> torch.Tensor:
        s = self.scfg
        return sample_keyed(logits, seeds, tok_idx, s.temperature, s.top_k, s.top_p, s.greedy)

    # ------------------------------------------------------------------
    def _admit_group(self, reqs: Sequence[Request], slots: Sequence[int]) -> None:
        """Prefill K requests (batch 2K: [cond_0..K, uncond_0..K]) into a
        small cache, sample their first tokens, copy every per-slot state
        tensor into the slot rows."""
        cfg, n, k = self.cfg, self.scfg.max_slots, len(reqs)
        model, dev = self.model, self.device
        slot_idx = self._to_device(slots, torch.int64)
        rows = torch.cat([slot_idx, slot_idx + n])  # (2K,)

        if cfg.model_type == "c2i":
            labels = self._to_device([r.label for r in reqs], torch.int64)
            prefix = gpt_model.embed_prefix_c2i(
                model, torch.cat([labels, torch.full_like(labels, cfg.num_classes)]))
        else:
            cap = torch.stack([self._to_device(r.caption_emb, self.dtype) for r in reqs])
            uncond = model.cls_embedding.uncond_embedding[None].expand_as(cap)
            prefix = gpt_model.embed_prefix_t2i(
                model, torch.cat([cap, uncond.to(cap.dtype)]))[:, : cfg.cls_token_num]

        feats = torch.stack([
            self._to_device(r.adapter_features, self.dtype) if r.adapter_features is not None
            else torch.zeros((cfg.block_size, cfg.adapter_dim), dtype=self.dtype, device=dev)
            for r in reqs])
        # the control MLPs are bias-free: zero features give zero control
        ct = gpt_model.mlp_gelu(model.adapter_mlp, feats)
        ct = gpt_model.mlp_gelu(model.condition_mlp, torch.cat([ct, torch.zeros_like(ct)]))
        fused3_req = gpt_model.fusion_projections(model, ct)  # (3, 2K, block, dim)
        masks = torch.stack([
            self._to_device(r.emb_mask, torch.bool) if r.emb_mask is not None
            else torch.ones(cfg.cls_token_num, dtype=torch.bool, device=dev) for r in reqs])
        col_req = torch.cat([masks, masks])  # (2K, T_cls)

        small = self._init_caches(2 * k)
        # the prefix rides in bf16, as in the JAX engine
        logits, small = dec.prefill_flat(model, cfg, small, prefix.to(torch.bfloat16),
                                         fused3_req, col_req, rope_table=self.rope)
        if self.scfg.kv_stacked:  # the slots lie on dim 1
            for dst, src in zip(_streams(self.caches), _streams(small)):
                dst[:, rows] = src
        else:
            for kv, skv in zip(self.caches, small):
                for dst, src in zip(_streams(kv), _streams(skv)):
                    dst[rows] = src
        self.fused[:, rows] = fused3_req.to(self.fused.dtype)
        col_full = torch.ones((2 * k, self.s_max), dtype=torch.bool, device=dev)
        col_full[:, : cfg.cls_token_num] = col_req
        self.col_mask[rows] = col_full

        scales = self._to_device([r.cfg_scale for r in reqs], torch.float32)
        seeds = self._to_device([r.seed & 0xFFFFFFFF for r in reqs], torch.int64)
        cond, uncond = torch.chunk(logits, 2, dim=0)
        tok = self._sample(uncond + (cond - uncond) * scales[:, None], seeds,
                           torch.zeros(k, dtype=torch.int64, device=dev))

        self.pos[rows] = cfg.cls_token_num
        self.cur_tok[rows] = torch.cat([tok, tok])
        self.cfg_scales[slot_idx] = scales
        self.strengths[slot_idx] = self._to_device([r.control_strength for r in reqs],
                                                   torch.float32)
        self.seeds[slot_idx] = seeds
        for req, slot in zip(reqs, slots):
            self.active[slot] = True
            self.emitted[slot] = 1
            self.slot_req[slot] = req
            self.outputs[req.request_id] = []
        meta = [(req, i) for i, req in enumerate(reqs)]
        if self.scfg.overlap_admission:
            self._inflight.append(("admit", *self._to_host(tok), meta))
        else:
            self._collect("admit", tok.cpu().numpy(), meta)

    # ------------------------------------------------------------------
    def _collect(self, kind: str, arr: np.ndarray, meta) -> None:
        """Apply a collected token buffer to the host-side outputs."""
        if kind == "admit":
            for req, i in meta:
                self.outputs[req.request_id].append(int(arr[i]))
            return
        # quantum: arr (q, slots), meta [(slot, req, take, done)]
        for slot, req, take, done in meta:
            self.outputs[req.request_id].extend(int(t) for t in arr[:take, slot])
            if done:
                req.tokens = np.asarray(self.outputs.pop(req.request_id), np.int32)
                req.t_done = time.perf_counter()
                self.finished.append(req)

    def _drain(self, block: bool) -> None:
        """Collect in-flight token buffers: all that have landed, plus (when
        block=True) at least the oldest one."""
        while self._inflight:
            kind, host, event, meta = self._inflight[0]
            if not block and event is not None and not event.query():
                return
            self._inflight.popleft()
            if event is not None:
                event.synchronize()
            self._collect(kind, host.numpy(), meta)
            block = False  # only the oldest is waited for

    # ------------------------------------------------------------------
    def _quantum(self, q: int) -> torch.Tensor:
        """Run exactly q lockstep decode steps; returns the sampled tokens
        (q, slots) on the device. Slots freeze once their block is emitted;
        frozen slots rewrite identical cache bytes in place."""
        cfg, n = self.cfg, self.scfg.max_slots
        stop = cfg.cls_token_num + cfg.block_size - 1
        active = self._to_device(np.concatenate([self.active, self.active]), torch.bool)
        strengths = torch.cat([self.strengths, self.strengths])[:, None, None]
        pos, cur, toks = self.pos, self.cur_tok, []
        for _ in range(q):
            logits, _ = dec.decode_step_multi(
                self.model, cfg, self.caches, cur, pos, self.fused,
                control_strength=strengths, use_flash=self.scfg.use_flash,
                col_mask_full=self.col_mask, rope_table=self.rope)
            cond, uncond = torch.chunk(logits, 2, dim=0)
            mixed = uncond + (cond - uncond) * self.cfg_scales[:, None]
            # index of the token being sampled for each slot (prefill = 0)
            nxt = self._sample(mixed, self.seeds, pos[:n].long() - cfg.cls_token_num + 1)
            # only active, not yet complete slots advance
            alive = active & (pos < stop)
            pos = torch.where(alive, pos + 1, pos)
            cur = torch.where(alive, torch.cat([nxt, nxt]), cur)
            toks.append(nxt)
        self.pos, self.cur_tok = pos, cur
        return torch.stack(toks)

    def _pick_quantum(self) -> int:
        """Smallest bucket covering the earliest-finishing active slot (the
        early-exit policy); the fixed quantum when buckets are off. Under the
        "occupancy" policy the quantum also shrinks with slot occupancy so
        free slots get refilled from new arrivals sooner."""
        buckets = self.scfg.quantum_buckets
        if not buckets:
            return self.scfg.quantum
        srt = sorted(buckets)
        n = self.scfg.max_slots
        remaining = [self.cfg.block_size - int(self.emitted[s])
                     for s in range(n) if self.active[s]]
        need = min(remaining) if remaining else max(buckets)
        q = next((b for b in srt if b >= need), srt[-1])
        if self.scfg.quantum_policy == "occupancy":
            n_active = len(remaining)
            if n_active < n:
                target = max(1, (srt[-1] * n_active + n - 1) // n)
                q = min(q, next((b for b in srt if b >= target), srt[-1]))
        return q

    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler iteration: group-admit -> decode quantum -> collect.

        Slot state (active, emitted) advances at enqueue time: a request
        emits exactly block_size tokens, so completion is known without the
        sampled values. In overlap mode the token buffers are collected
        lazily (at most overlap_depth quanta in flight) and step() returns
        once the device work is enqueued."""
        overlap = self.scfg.overlap_admission
        n = self.scfg.max_slots
        if overlap:
            self._drain(block=False)
        free = [s for s in range(n) if not self.active[s]]
        group, slots = [], []
        while free and self.waiting:
            group.append(self.waiting.popleft())
            slots.append(free.pop(0))
        if group:
            self._admit_group(group, slots)
        if not self.active.any():
            if overlap:
                self._drain(block=bool(self._inflight))
            return
        if overlap:
            n_quanta = sum(1 for kind, *_ in self._inflight if kind == "quantum")
            if n_quanta >= self.scfg.overlap_depth:
                self._drain(block=True)
        q = self._pick_quantum()
        toks = self._quantum(q)
        self.stats["slot_steps"] += q * n
        meta = []
        for s in range(n):
            if not self.active[s]:
                continue
            req = self.slot_req[s]
            take = int(min(q, self.cfg.block_size - self.emitted[s]))
            self.stats["useful_steps"] += take
            self.emitted[s] += take
            done = self.emitted[s] >= self.cfg.block_size
            meta.append((s, req, take, done))
            if done:
                self.active[s] = False
                self.slot_req[s] = None
        if overlap:
            self._inflight.append(("quantum", *self._to_host(toks), meta))
        else:
            self._collect("quantum", toks.cpu().numpy(), meta)

    def flush(self) -> None:
        """Block until every in-flight token buffer is collected."""
        while self._inflight:
            self._drain(block=True)

    def run(self, requests: List[Request]) -> List[Request]:
        """Offline batch entry: serve every request; returns them finished,
        sorted by request_id."""
        for r in requests:
            self.add_request(r)
        while self.has_unfinished():
            self.step()
        done, self.finished = self.finished, []
        return sorted(done, key=lambda r: r.request_id)
