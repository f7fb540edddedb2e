"""Causal flash attention for training, forward and backward.

`flash_attention_train(q, k, v, key_valid)` has the semantics of the JAX
package's `ops/flash_train_pallas.flash_attention_train_pallas`: q, k, v (B,
T, H, D), key_valid an optional (B, T) bool column mask (False = masked,
left-padded caption columns), output (B, T, H, D) in q's dtype. Scores are
causal plus the additive column bias (0 or -1e9) with a finite -1e9 on the
masked columns and no diagonal exception: a fully masked row (a left-padded
caption row) is finite junk whose output reaches no kept logit, so its
cotangent is zero and the loss and every parameter gradient equal those of
the masked einsum with the diagonal exception.

The forward is the custom operator `controlar_torch::flash_train_fwd` ->
(out, lse), differentiable through `register_autograd`: it saves (q, k, v,
bias, out, lse), and its backward computes delta = rowsum(dO * O) in torch
and runs the dq and dk/dv passes. Being an operator, the forward is visible
to selective activation checkpointing: a policy that saves its outputs
(`models/gpt.py`, remat "attn" and "qkv_attn") never runs it again in the
backward.

Three kernels, hand-written CUDA in `csrc/flash_train.cu`, each behind a
launcher with a launch count: `flash_train_fwd` (out, lse), `flash_train_dq`
and `flash_train_dkv`. The forward has two variants, chosen by the head
dimension alone (`fwd_variant`): at D 64 and 128 a TMA-fed wgmma kernel (a
block is one warpgroup of 64 query rows, whose thread 0 keeps the K / V
tiles in flight into an mbarrier ring, and both products run on `wgmma`),
at every other D (GPT-3B's 100: its heads are 200 bytes apart, and a
tensor map takes 16-byte strides) a cp.async ring and `mma.sync`, as dq and
dk/dv. On a CPU tensor each launcher computes the same function with the
plain versions `flash_train_fwd_ref` / `flash_train_bwd_ref`, which repeat
the kernels' numerics: q, k, v rounded to bf16; scores, the softmax
statistics and every accumulator fp32; p rounded to bf16 before the p.v and
p^T.dO products, ds before the ds.k and ds^T.q products.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from controlar_tpu_torch import _build

NEG = -1e9

# head dimensions whose forward runs the TMA / wgmma kernel: a tensor map
# needs 16-byte strides (D 64 and 128 heads are 128 and 256 bytes apart, D
# 100 heads 200); every other D runs the cp.async kernel
TMA_HEAD_DIMS = (64, 128)


def padded_head_dim(d: int) -> int:
    """The kernels' padded head dimension (the source's `padded`)."""
    if d <= 0 or d % 4 or d > 128:
        raise ValueError(f"head dim {d}: the kernels take multiples of 4 up to 128")
    return 64 if d <= 64 else (112 if d <= 112 else 128)


def fwd_variant(d: int) -> str:
    """The forward kernel that head dimension d runs: "tma" or "cp.async"."""
    padded_head_dim(d)
    return "tma" if d in TMA_HEAD_DIMS else "cp.async"


def key_bias(key_valid: Optional[Tensor]) -> Optional[Tensor]:
    """(B, T) bool column mask -> (B, T) f32 additive bias (0 / -1e9)."""
    if key_valid is None:
        return None
    return torch.where(key_valid.bool(), 0.0, NEG).float()


def _bf(x: Tensor) -> Tensor:
    """x rounded to bf16, as fp32."""
    return x.to(torch.bfloat16).float()


def _scores(qf: Tensor, kf: Tensor, kbias: Optional[Tensor]) -> Tensor:
    """(B, H, T, T) fp32: q.k / sqrt(D), plus the bias on the causal columns,
    -1e9 on the others."""
    t, d = qf.shape[1], qf.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * (1.0 / math.sqrt(d))
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    causal = torch.ones(t, t, dtype=torch.bool, device=qf.device).tril()
    return s.masked_fill(~causal, NEG)


def flash_train_fwd_ref(q: Tensor, k: Tensor, v: Tensor,
                        kbias: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Plain version of the forward kernel -> (out (B, T, H, D) in q's dtype,
    lse (B, H, T) f32)."""
    s = _scores(_bf(q), _bf(k), kbias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhts,bshd->bhtd", _bf(p), _bf(v))
    out = (acc / l).transpose(1, 2)
    return out.to(q.dtype).contiguous(), (m + torch.log(l))[..., 0]


def flash_train_bwd_ref(q: Tensor, k: Tensor, v: Tensor, kbias: Optional[Tensor],
                        dout: Tensor, lse: Tensor, delta: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the dq and dk/dv kernels -> (dq, dk, dv) in the
    dtypes of q, k, v. lse and delta (= rowsum(dO * O)) are (B, H, T) f32."""
    qf, kf, vf, do = _bf(q), _bf(k), _bf(v), _bf(dout)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(qf, kf, kbias) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do, vf)
    ds = _bf(p * (dp - delta[..., None]) * scale)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", _bf(p), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor, kbias: Optional[Tensor]) -> None:
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    padded_head_dim(d)
    if kbias is not None and (kbias.shape != (b, t) or kbias.dtype != torch.float32):
        raise ValueError(f"kbias must be (B, T) float32, got {kbias.shape} {kbias.dtype}")
    for x in (q, k, v, kbias):
        if x is not None and x.device != q.device:
            raise ValueError(f"tensors on {x.device} and {q.device}")


def _bf16(x: Tensor) -> Tensor:
    """x as a contiguous bf16 tensor whose rows the kernels load 8 bytes at
    a time (a view at an odd offset is copied)."""
    x = x.to(torch.bfloat16).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _entry(name: str, n_ptr: int):
    """The C entry `name` of csrc/flash_train.cu with its argument types:
    n_ptr pointers, then out_f32, B, T, H, D and the stream."""
    f = getattr(_build.load("flash_train"), name)
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * n_ptr + [i] * 5 + [p]
        f.restype = ctypes.c_int
    return f


_ENCODE_FAILED = -1  # csrc/flash_train.cu's kEncodeFailed


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(x: Optional[Tensor]):
    return None if x is None else x.data_ptr()


def _cuda(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def flash_train_fwd(q: Tensor, k: Tensor, v: Tensor,
                    kbias: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """-> (out (B, T, H, D) in q's dtype, lse (B, H, T) f32): the forward
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if not _cuda(q):
        return flash_train_fwd_ref(q, k, v, kbias)
    _check(q, k, v, kbias)
    _check_out_dtype(q)
    b, t, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    # locals hold the bf16 copies until the launch is queued
    q16, k16, v16 = _bf16(q), _bf16(k), _bf16(v)
    kb = None if kbias is None else kbias.contiguous()
    f = _entry("flash_train_fwd", 6)
    err = f(q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), _ptr(kb), out.data_ptr(),
            lse.data_ptr(), int(out.dtype == torch.float32), b, t, h, d,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err == _ENCODE_FAILED:
        raise RuntimeError("flash_train_fwd: cuTensorMapEncodeTiled refused the q, k, v maps")
    _raise_on(err, "flash_train_fwd")
    flash_train_fwd.launches += 1
    return out, lse


flash_train_fwd.launches = 0


def _check_out_dtype(x: Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"outputs are written as bf16 or float32, not {x.dtype}")


def _check_bwd(q: Tensor, dout: Tensor, lse: Tensor, delta: Tensor) -> None:
    b, t, h, _ = q.shape
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {dout.shape} on {dout.device} does not match q {q.shape}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, t) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be (B, H, T) float32 on {q.device}, got "
                             f"{x.shape} {x.dtype} on {x.device}")


def flash_train_dq(q: Tensor, k: Tensor, v: Tensor, kbias: Optional[Tensor], dout: Tensor,
                   lse: Tensor, delta: Tensor) -> Tensor:
    """-> dq in q's dtype: the dq kernel on a CUDA tensor, the plain backward
    on a CPU tensor."""
    if not _cuda(q):
        return flash_train_bwd_ref(q, k, v, kbias, dout, lse, delta)[0]
    _check(q, k, v, kbias)
    _check_bwd(q, dout, lse, delta)
    _check_out_dtype(q)
    b, t, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q16, k16, v16, do16 = _bf16(q), _bf16(k), _bf16(v), _bf16(dout)
    kb = None if kbias is None else kbias.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    f = _entry("flash_train_dq", 8)
    _raise_on(f(q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), _ptr(kb), do16.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), int(dq.dtype == torch.float32),
                b, t, h, d, torch.cuda.current_stream(q.device).cuda_stream), "flash_train_dq")
    flash_train_dq.launches += 1
    return dq


flash_train_dq.launches = 0


def flash_train_dkv(q: Tensor, k: Tensor, v: Tensor, kbias: Optional[Tensor], dout: Tensor,
                    lse: Tensor, delta: Tensor) -> Tuple[Tensor, Tensor]:
    """-> (dk, dv) in k's and v's dtype: the dk/dv kernel on a CUDA tensor,
    the plain backward on a CPU tensor."""
    if not _cuda(q):
        return flash_train_bwd_ref(q, k, v, kbias, dout, lse, delta)[1:]
    _check(q, k, v, kbias)
    _check_bwd(q, dout, lse, delta)
    _check_out_dtype(k)
    if v.dtype != k.dtype:
        raise ValueError(f"k and v dtypes differ: {k.dtype} {v.dtype}")
    b, t, h, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    q16, k16, v16, do16 = _bf16(q), _bf16(k), _bf16(v), _bf16(dout)
    kb = None if kbias is None else kbias.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    f = _entry("flash_train_dkv", 9)
    _raise_on(f(q16.data_ptr(), k16.data_ptr(), v16.data_ptr(), _ptr(kb), do16.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(dk.dtype == torch.float32), b, t, h, d,
                torch.cuda.current_stream(q.device).cuda_stream), "flash_train_dkv")
    flash_train_dkv.launches += 1
    return dk, dv


flash_train_dkv.launches = 0


@torch.library.custom_op("controlar_torch::flash_train_fwd", mutates_args=())
def flash_train_op(q: Tensor, k: Tensor, v: Tensor,
                   kbias: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """The differentiable forward -> (out, lse); see the module docstring."""
    return flash_train_fwd(q, k, v, kbias)


@flash_train_op.register_fake
def _(q, k, v, kbias):
    b, t, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, kbias = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, kbias, out, lse)


def _backward(ctx, dout, _dlse):
    q, k, v, kbias, out, lse = ctx.saved_tensors
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_train_dq(q, k, v, kbias, dout, lse, delta)
    dk, dv = flash_train_dkv(q, k, v, kbias, dout, lse, delta)
    return dq, dk, dv, None


flash_train_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_train(q: Tensor, k: Tensor, v: Tensor,
                          key_valid: Optional[Tensor] = None) -> Tensor:
    """Differentiable causal attention: q, k, v (B, T, H, D), key_valid
    (B, T) bool or None -> (B, T, H, D) in q's dtype."""
    out, _ = flash_train_op(q, k, v, key_bias(key_valid))
    return out


@torch.library.custom_op("controlar_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: Tensor, name: str) -> Tensor:
    """Identity (a copy) that names x for selective checkpointing: a policy
    sees the operator and its `name` argument and may save its output (the
    JAX package's `checkpoint_name`)."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None),
                                  setup_context=lambda ctx, inputs, output: None)
