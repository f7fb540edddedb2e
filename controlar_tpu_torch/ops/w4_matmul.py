"""W4A16: int4 group-quantized weights, the dequant-matmul and the fused FFN.

Packing ("group-pair planes", the JAX package's layout, so weights carry
across unchanged): the contraction dim K is zero-padded to Kp, a multiple of
2*GROUP, and cut into GROUP-row planes; carrier row p*G + i holds plane 2p's
row i in its low nibble and plane 2p+1's row i in its high nibble:

    carrier[p*G + i, j] = (q[2p*G + i, j] & 0xF) | (q[(2p+1)*G + i, j] << 4)

Carriers are (Kp/2, N) int8 with N contiguous; scales are per (plane,
column) f32, (Kp/GROUP, N). q lies in [-7, 7]; padded planes quantize to 0.

`w4_matmul` and `w4_ffn` launch the hand-written kernels of
`csrc/w4_matmul.cu` and `csrc/w4_ffn.cu` on CUDA tensors and compute the
same function with their plain versions (`*_ref`) on CPU tensors. The TPU
kernel's VMEM budgeting (slot depth, N-split) has no counterpart here. The
kernels split K for the narrow products (`_splits`); their fp32 workspace
and per-tile arrival counters are kept per device and stream
(`ops/_scratch.py`), grown when a call needs more, and the counters are
zeroed once and left zero by every launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from controlar_tpu_torch import _build
from controlar_tpu_torch.ops._scratch import _scratch_for, _sm_count

GROUP = 128  # rows per scale along K; the kernels take this group only
MAX_ROWS = 256  # the decode path sends at most this many rows to a kernel
TILE_N = 128  # columns of a kernel work item
SPLIT_ITEMS_PER_SM = 2  # the split of K aims at this many work items per SM


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def unpack_nibbles(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 carriers -> (lo, hi) sign-extended nibble planes, int32."""
    ci = c.to(torch.int32)
    return (ci << 28) >> 28, ci >> 4


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Integer (lo, hi) in [-8, 7] -> int8 carriers, lo in the low nibble."""
    c = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return c.to(torch.uint8).view(torch.int8)


def group_of(q4: torch.Tensor, s: torch.Tensor) -> int:
    """The group size, from the packed shapes."""
    return 2 * q4.shape[0] // s.shape[0]


def quantize_weight_w4(w: torch.Tensor, group: int = GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (carriers (Kp/2, N) int8, scales (Kp/group, N) f32).

    Symmetric per-(group, column) int4: s = max(amax / 7, 1e-12),
    q = clip(round(w / s), -7, 7)."""
    k, n = w.shape
    kp = _pad_to(k, 2 * group)
    w32 = torch.zeros((kp, n), dtype=torch.float32, device=w.device)
    w32[:k] = w.float()
    g = w32.reshape(kp // group, group, n)
    amax = g.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax / 7.0, min=1e-12)
    q = torch.clamp(torch.round(g / s), -7, 7).to(torch.int32)
    planes = q.reshape(kp // group // 2, 2, group, n)
    carriers = pack_nibbles(planes[:, 0], planes[:, 1]).reshape(kp // 2, n)
    return carriers.contiguous(), s[:, 0, :].contiguous()


def dequantize_weight_w4(q4: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16,
                         k: Optional[int] = None) -> torch.Tensor:
    """-> (K, N) (or (Kp, N) without k) in dtype; padded rows are zero."""
    kp2, n = q4.shape
    g = group_of(q4, s)
    lo, hi = unpack_nibbles(q4)
    planes = torch.stack([lo.reshape(kp2 // g, g, n), hi.reshape(kp2 // g, g, n)], dim=1)
    w = planes.reshape(2 * kp2 // g, g, n).float() * s[:, None, :]
    w = w.reshape(2 * kp2, n)
    return (w if k is None else w[:k]).to(dtype)


def _planes_real(k: int, kp: int, group: int) -> int:
    """Planes the product reads: K/group when K is a group multiple (x stays
    unpadded and the zero padding planes are skipped), else all Kp/group
    (x is zero-padded to Kp)."""
    return k // group if k % group == 0 else kp // group


def w4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version with the Pallas kernel's numerics: x rounded to bf16,
    an fp32 partial sum per plane, each times its plane's scale, summed
    over the planes in order (lo then hi of each carrier chunk)."""
    b, k = x.shape
    kp2, n = q4.shape
    group = group_of(q4, s)
    nfull = _planes_real(k, 2 * kp2, group)
    xp = torch.zeros((b, nfull * group), dtype=torch.float32, device=x.device)
    width = min(k, nfull * group)
    xp[:, :width] = x[:, :width].to(torch.bfloat16).float()
    lo, hi = unpack_nibbles(q4)
    acc = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    for p in range((nfull + 1) // 2):
        rows = slice(p * group, (p + 1) * group)
        part = (xp[:, 2 * p * group:(2 * p + 1) * group] @ lo[rows].float()) * s[2 * p]
        if 2 * p + 1 < nfull:
            part = part + (xp[:, (2 * p + 1) * group:(2 * p + 2) * group]
                           @ hi[rows].float()) * s[2 * p + 1]
        acc = acc + part
    return acc.to(out_dtype or x.dtype)


def w4_ffn_fits(q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                rows: int, k: int) -> bool:
    """Shape gate of the fused FFN kernel: both weights W4 with the kernels'
    group, K and F multiples of it, carriers padded as quantize_weight_w4
    pads them, at most MAX_ROWS rows."""
    group = group_of(q13, s13)
    if group != GROUP or group_of(q2, s2) != GROUP or not 1 <= rows <= MAX_ROWS:
        return False
    f = q13.shape[1] // 2
    return (q13.shape[1] % 2 == 0 and k % group == 0 and f % group == 0
            and 2 * q13.shape[0] == _pad_to(k, 2 * group)
            and 2 * q2.shape[0] == _pad_to(f, 2 * group) and q2.shape[1] % 16 == 0)


def w4_ffn_ref(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
               s2: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the fused SwiGLU FFN over the fused [w1 | w3] W4
    weight: the w13 accumulator rounded to bf16, silu(h1) * h3 in fp32, z
    rounded to bf16, then z @ w2 (as the Pallas kernel does)."""
    f = q13.shape[1] // 2
    y = w4_matmul_ref(x, q13, s13, torch.float32).to(torch.bfloat16).float()
    h1, h3 = y[:, :f], y[:, f:]
    z = (h1 * torch.sigmoid(h1) * h3).to(torch.bfloat16)
    return w4_matmul_ref(z, q2, s2, torch.float32).to(out_dtype or x.dtype)


def _check_weight(q4, s, name):
    if q4.dim() != 2 or q4.dtype != torch.int8 or s.dim() != 2 or s.dtype != torch.float32:
        raise ValueError(f"{name}: carriers must be 2-D int8 and scales 2-D float32, got "
                         f"{tuple(q4.shape)} {q4.dtype}, {tuple(s.shape)} {s.dtype}")
    kp2, n = q4.shape
    if s.shape[1] != n or s.shape[0] == 0 or (2 * kp2) % s.shape[0] or group_of(q4, s) != GROUP:
        raise ValueError(f"{name}: the kernels take group {GROUP}; carriers {tuple(q4.shape)} "
                         f"and scales {tuple(s.shape)} do not match it")
    if s.shape[0] % 2 or n % 16:
        raise ValueError(f"{name}: scale rows ({s.shape[0]}) must be even and columns ({n}) "
                         "a multiple of 16")


def _check_cuda(tensors, x):
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is cuda:"
                         f"{torch.cuda.current_device()}")


def _x_operand(x: torch.Tensor, kp: int) -> Tuple[torch.Tensor, int]:
    """x as the kernel reads it: bf16 (B, nfull*GROUP), unpadded when K is a
    group multiple, else zero-padded to Kp. Returns (x, nfull)."""
    b, k = x.shape
    nfull = _planes_real(k, kp, GROUP)
    xb = x.to(torch.bfloat16)
    if nfull * GROUP != k:
        xp = torch.zeros((b, nfull * GROUP), dtype=torch.bfloat16, device=x.device)
        xp[:, :k] = xb
        xb = xp
    return xb.contiguous(), nfull


def _out_f32(dtype: torch.dtype) -> int:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {dtype}")
    return int(dtype == torch.float32)


def _splits(nchunk: int, col_tiles: int, sms: int) -> int:
    """Slices of K (in chunks of two planes) for a product of col_tiles
    column tiles: enough work items for SPLIT_ITEMS_PER_SM on every SM, in
    balanced slices. It depends on (K, N) and the card only, never on the
    rows, so that a row's result does not depend on the rows beside it."""
    want = max(1, min(nchunk, SPLIT_ITEMS_PER_SM * sms // col_tiles))
    per = -(-nchunk // want)
    return -(-nchunk // per)


def _fn(lib: str, name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def w4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (B, K) @ W4 (K, N) -> (B, N) in out_dtype (x's dtype by default)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w4_matmul_ref(x, q4, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or x.shape[0] == 0:
        raise ValueError(f"x must be (B, K) bf16/f32 with B >= 1, got {tuple(x.shape)} {x.dtype}")
    _check_weight(q4, s, "w4_matmul")
    b, k = x.shape
    kp2, n = q4.shape
    if k > 2 * kp2:
        raise ValueError(f"x has K={k} columns, the weight holds {2 * kp2}")
    f32 = _out_f32(out_dtype)
    xb, nfull = _x_operand(x, 2 * kp2)
    _check_cuda((xb, q4, s), x)
    tiles = -(-n // TILE_N)
    splits = _splits((nfull + 1) // 2, tiles, _sm_count(x.device.index))
    out = torch.empty((b, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters, ws = _scratch_for(x.device, stream, tiles * -(-b // 16),
                                splits * b * n if splits > 1 else 0)
    err = _fn("w4_matmul", "w4_matmul", 6, 5)(
        xb.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), f32, b, nfull, n, splits, stream)
    if err != 0:
        raise RuntimeError(f"w4_matmul launch failed: cudaError {err}")
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0


def w4_ffn(x: torch.Tensor, q13: torch.Tensor, s13: torch.Tensor, q2: torch.Tensor,
           s2: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3) @ w2 over the fused [w1 | w3] W4 weight, one
    kernel launch. x (B, K) -> (B, N) in out_dtype (x's dtype by default)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return w4_ffn_ref(x, q13, s13, q2, s2, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be (B, K) bf16/f32, got {tuple(x.shape)} {x.dtype}")
    _check_weight(q13, s13, "w4_ffn w13")
    _check_weight(q2, s2, "w4_ffn w2")
    b, k = x.shape
    if not w4_ffn_fits(q13, s13, q2, s2, b, k):
        raise ValueError(f"w4_ffn does not take x {tuple(x.shape)}, w13 {tuple(q13.shape)}, "
                         f"w2 {tuple(q2.shape)} (see w4_ffn_fits)")
    f32 = _out_f32(out_dtype)
    f, n = q13.shape[1] // 2, q2.shape[1]
    sms = _sm_count(x.device.index)
    splits1 = _splits((k // GROUP + 1) // 2, 2 * f // TILE_N, sms)
    splits2 = _splits((f // GROUP + 1) // 2, -(-n // TILE_N), sms)
    xb = x.to(torch.bfloat16).contiguous()
    z = torch.empty((b, f), dtype=torch.bfloat16, device=x.device)  # the gate's output
    out = torch.empty((b, n), dtype=out_dtype, device=x.device)
    n1 = splits1 * b * 2 * f  # ws1 (splits1, B, 2F), then ws2 (splits2, B, N) when split
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters, ws = _scratch_for(x.device, stream, (f // TILE_N + -(-n // TILE_N)) * -(-b // 16),
                                n1 + (splits2 * b * n if splits2 > 1 else 0))
    _check_cuda((xb, q13, s13, q2, s2, z), x)
    err = _fn("w4_ffn", "w4_ffn", 10, 7)(
        xb.data_ptr(), q13.data_ptr(), s13.data_ptr(), q2.data_ptr(), s2.data_ptr(),
        z.data_ptr(), out.data_ptr(), ws.data_ptr(), ws[n1:].data_ptr() if splits2 > 1 else None,
        counters.data_ptr(), f32, b, k, f, n, splits1, splits2, stream)
    if err != 0:
        raise RuntimeError(f"w4_ffn launch failed: cudaError {err}")
    w4_ffn.launches += 1
    return out


w4_ffn.launches = 0
