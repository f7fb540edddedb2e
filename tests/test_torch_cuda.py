"""Kernel tests that need an NVIDIA card; they skip without one.

Run on the card without the JAX test configuration:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from controlar_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_q4,
    flash_decode_attention_q4_ref,
    flash_decode_attention_q8,
    flash_decode_attention_q8_append,
    flash_decode_attention_q8_append_ref,
    flash_decode_attention_q8_ref,
    flash_decode_attention_ref,
)
from controlar_tpu_torch.ops.w4_matmul import (
    quantize_weight_w4,
    w4_ffn,
    w4_ffn_ref,
    w4_matmul,
    w4_matmul_ref,
)
from controlar_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, b, s, h, d, pos, bias, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h * d, generator=g, device=dev) * 0.5).bfloat16()
    kv = (torch.randn(b, s, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    return q, kv, pos, col_bias


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("pos", [0, 1, 255, 256, 575, "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_plain_version(dev, d, pos, bias):
    b, s, h = 4, 768, 3
    if pos == "per_slot":
        pos = torch.tensor([0, 300, 511, 767], dtype=torch.int32, device=dev)
    q, kv, pos, col_bias = _inputs(dev, b, s, h, d, pos, bias)
    out = flash_decode_attention(q, kv, pos, col_bias, n_head=h)
    torch.cuda.synchronize()
    want = flash_decode_attention_ref(q, kv, pos, col_bias, n_head=h)
    # both round the output to bf16 (step 2**-7 relative): rtol covers one step
    # at any size, atol one step below 0.5; a dropped block of rows fails
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)


def test_f32_query_gives_f32_output(dev):
    q, kv, pos, _ = _inputs(dev, 2, 256, 2, 64, 100, False)
    out = flash_decode_attention(q.float(), kv, pos, n_head=2)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, flash_decode_attention_ref(q.float(), kv, pos, n_head=2),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "noncontig", "bias_shape"])
def test_wrapper_rejects(dev, bad):
    q, kv, pos, _ = _inputs(dev, 2, 256, 2, 64, 10, False)
    kwargs = {"n_head": 2}
    bias = None
    if bad == "head_dim":
        kwargs["n_head"] = 4  # head_dim 32
        q = q.reshape(2, 128)
    elif bad == "dtype":
        kv = kv.half()
    elif bad == "noncontig":
        kv = torch.cat([kv, kv], dim=1)[:, ::2]
    else:
        bias = torch.zeros(2, 7, device=dev)
    with pytest.raises(ValueError):
        flash_decode_attention(q, kv, pos, bias, **kwargs)


def test_launch_count(dev):
    q, kv, pos, _ = _inputs(dev, 2, 256, 2, 64, 10, False)
    flash_decode_attention.launches = 0
    for _ in range(3):
        flash_decode_attention(q, kv, pos, n_head=2)
    assert flash_decode_attention.launches == 3
    assert np.isfinite(flash_decode_attention(q, kv, pos, n_head=2).float().cpu().numpy()).all()


# ---- quantized caches: int8 (q8) and int4 (q4) decode attention ----------

def _quant_inputs(dev, kind, b, s, h, d, pos, bias, split=False, seed=1):
    q, kv, pos, col_bias = _inputs(dev, b, s, h, d, pos, bias, seed)
    if kind == "q8":
        rows, scale = quantize_kv_rows(kv, h)
    else:
        rows, scale = quantize_kv_rows_4(kv, h, split=split)
    return q, rows, scale, pos, col_bias


def _per_slot(dev, pos):
    if pos == "per_slot":
        return torch.tensor([0, 300, 511, 767], dtype=torch.int32, device=dev)
    return pos


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("pos", [0, 1, 255, 256, 575, "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_q8_kernel_matches_plain_version(dev, d, pos, bias):
    q, kv, scale, pos, col_bias = _quant_inputs(dev, "q8", 4, 768, 3, d, _per_slot(dev, pos), bias)
    out = flash_decode_attention_q8(q, kv, scale, pos, col_bias, n_head=3)
    torch.cuda.synchronize()
    want = flash_decode_attention_q8_ref(q, kv, scale, pos, col_bias, n_head=3)
    # bf16 outputs on both sides, as in the bf16 kernel's test
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("pos", [0, 255, 256, "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_q4_kernel_matches_plain_version(dev, d, pos, bias, split):
    q, kv, scale, pos, col_bias = _quant_inputs(dev, "q4", 4, 768, 3, d, _per_slot(dev, pos),
                                                bias, split)
    out = flash_decode_attention_q4(q, kv, scale, pos, col_bias, n_head=3, head_dim=d,
                                    split=split)
    torch.cuda.synchronize()
    want = flash_decode_attention_q4_ref(q, kv, scale, pos, col_bias, n_head=3, head_dim=d,
                                         split=split)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("kind", ["q8", "q4"])
@pytest.mark.parametrize("bad", ["head_dim", "kv_dtype", "noncontig", "scale_shape"])
def test_quant_wrappers_reject(dev, kind, bad):
    q, kv, scale, pos, _ = _quant_inputs(dev, kind, 2, 256, 2, 64, 10, False)
    h, d = 2, 64
    if bad == "head_dim":
        h, d = 4, 32
    elif bad == "kv_dtype":
        kv = kv.to(torch.int16)
    elif bad == "noncontig":
        kv = torch.cat([kv, kv], dim=1)[:, ::2]
    else:
        scale = scale[..., :-1].contiguous()
    with pytest.raises(ValueError):
        if kind == "q8":
            flash_decode_attention_q8(q, kv, scale, pos, n_head=h)
        else:
            flash_decode_attention_q4(q, kv, scale, pos, n_head=h, head_dim=d)


def test_quant_launch_counts(dev):
    q, kv, scale, pos, _ = _quant_inputs(dev, "q8", 2, 256, 2, 64, 10, False)
    q4a = _quant_inputs(dev, "q4", 2, 256, 2, 64, 10, False)
    flash_decode_attention_q8.launches = flash_decode_attention_q4.launches = 0
    for _ in range(3):
        flash_decode_attention_q8(q, kv, scale, pos, n_head=2)
    flash_decode_attention_q4(*q4a[:4], n_head=2, head_dim=64)
    assert (flash_decode_attention_q8.launches, flash_decode_attention_q4.launches) == (3, 1)


# ---- int8 decode attention with the in-flight row appended (B11) --------

def _append_inputs(dev, d, pos, bias, b=4, s=768, h=3):
    q, kv, scale, pos, col_bias = _quant_inputs(dev, "q8", b, s, h, d, pos, bias, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    new_kv, new_s = quantize_kv_rows(torch.randn(b, 2 * h * d, generator=g, device=dev), h)
    if col_bias is not None:  # the contract: 0 at every decode position
        p = torch.as_tensor(pos, device=dev).long().reshape(-1).expand(b)
        col_bias[torch.arange(b, device=dev), p] = 0.0
    return q, new_kv, new_s, kv, scale, pos, col_bias


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("pos", [1, 255, 256, 767, "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_q8_append_kernel_matches_plain_version(dev, d, pos, bias):
    if pos == "per_slot":
        pos = torch.tensor([1, 300, 511, 767], dtype=torch.int32, device=dev)
    q, new_kv, new_s, kv, scale, pos, col_bias = _append_inputs(dev, d, pos, bias)
    kv_want, s_want = kv.clone(), scale.clone()
    flash_decode_attention_q8_append.launches = 0
    out, kv_out, s_out = flash_decode_attention_q8_append(q, new_kv, new_s, kv, scale, pos,
                                                          col_bias, n_head=3)
    torch.cuda.synchronize()
    assert flash_decode_attention_q8_append.launches == 1
    assert kv_out is kv and s_out is scale  # written in place
    want, _, _ = flash_decode_attention_q8_append_ref(q, new_kv, new_s, kv_want, s_want, pos,
                                                      col_bias, n_head=3)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)
    assert torch.equal(kv, kv_want) and torch.equal(scale, s_want)


@pytest.mark.parametrize("bad", ["new_kv_dtype", "new_s_shape", "kv_dtype", "pos_zero",
                                 "pos_past_cache"])
def test_q8_append_rejects(dev, bad):
    q, new_kv, new_s, kv, scale, pos, _ = _append_inputs(dev, 64, 10, False, b=2, s=256, h=2)
    if bad == "new_kv_dtype":
        new_kv = new_kv.bfloat16()
    elif bad == "new_s_shape":
        new_s = new_s[:, :2].contiguous()
    elif bad == "kv_dtype":
        kv = kv.to(torch.int16)
    else:
        pos = 0 if bad == "pos_zero" else 256
    flash_decode_attention_q8_append.launches = 0
    with pytest.raises(ValueError):
        flash_decode_attention_q8_append(q, new_kv, new_s, kv, scale, pos, n_head=2)
    assert flash_decode_attention_q8_append.launches == 0


# ---- the split int8 kernels (B2, B12-q8, B11): chunk boundaries, batch ----
# ---- invariance, determinism, counters, CUDA-graph replay ----------------

Q8_KINDS = ("flat", "stacked", "append")


def _q8_inputs(dev, b, s, h, d, bias, seed=5):
    """q, a 2-layer int8 stack and its scales, the in-flight row and its
    scales, and a left-padded caption bias (row i's first 7 i columns) or
    None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h * d, generator=g, device=dev) * 0.5).bfloat16()
    stack, sc = quantize_kv_rows(torch.randn(2, b, s, 2 * h * d, generator=g, device=dev) * 0.5, h)
    new_kv, new_s = quantize_kv_rows(torch.randn(b, 2 * h * d, generator=g, device=dev) * 0.5, h)
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    return dict(q=q, stack=stack, sc=sc, new_kv=new_kv, new_s=new_s, bias=col_bias)


def _q8_rows(x, rows):
    """The inputs of the batch rows `rows` alone."""
    return {k: None if v is None else (v[:, rows] if k in ("stack", "sc") else v[rows]).contiguous()
            for k, v in x.items()}


def _q8_run(kind, x, pos, plain=False):
    """The kind's kernel (or plain version) on the inputs x: the flat kernel
    on layer 0 of the stack, the stacked kernel on layer 1, the append on
    copies of layer 0's slabs (returned with the output). The bias is set to
    0 at the in-flight row, as the stacked kernels' callers keep it."""
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    b, s, h = x["q"].shape[0], x["stack"].shape[2], x["sc"].shape[-1] // 2
    cb = x["bias"]
    if cb is not None and kind != "flat":
        cb = cb.clone()
        p = torch.as_tensor(pos, device=cb.device).long().reshape(-1).expand(b)
        cb[torch.arange(b, device=cb.device), p.clamp(max=s - 1)] = 0.0
    if kind == "flat":
        fn = flash_decode_attention_q8_ref if plain else flash_decode_attention_q8
        return fn(x["q"], x["stack"][0], x["sc"][0], pos, cb, n_head=h)
    if kind == "stacked":
        fn = fds.flash_stacked_q8_ref if plain else fds.flash_stacked_q8
        return fn(x["q"], x["new_kv"], x["new_s"], x["stack"], x["sc"], 1, pos, cb, n_head=h)
    fn = flash_decode_attention_q8_append_ref if plain else flash_decode_attention_q8_append
    return fn(x["q"], x["new_kv"], x["new_s"], x["stack"][0].clone(), x["sc"][0].clone(), pos,
              cb, n_head=h)


def _q8_positions(kind, d, s):
    """Positions on each side of a chunk boundary (the live rows, pos + 1 in
    all three kernels, end one before, on and one after it), 0 (1 for the
    append, which needs a prefill before it) and S - 1."""
    from controlar_tpu_torch.ops.flash_decode import Q8_CHUNK_ROWS

    c = Q8_CHUNK_ROWS[d]
    return {"chunk-1": c - 2, "chunk": c - 1, "chunk+1": c, "zero": int(kind == "append"),
            "last": s - 1, "per_slot": [c - 2, c - 1, c, s - 1]}


@pytest.mark.parametrize("kind", Q8_KINDS)
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("pos", ["chunk-1", "chunk", "chunk+1", "zero", "last", "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_q8_split_kernels_match_plain_versions(dev, kind, d, h, pos, bias):
    """H = 3 at D = 100 gives 600-byte rows (8-byte copies), H = 4 800-byte
    rows (16-byte copies)."""
    b, s = 4, 768
    pos = _q8_positions(kind, d, s)[pos]
    if isinstance(pos, list):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    x = _q8_inputs(dev, b, s, h, d, bias)
    got = _q8_run(kind, x, pos)
    torch.cuda.synchronize()
    want = _q8_run(kind, x, pos, plain=True)
    if kind == "append":
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        got, want = got[0], want[0]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)


def _q8_equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def _q8_row(out, i):
    if isinstance(out, tuple):  # the output and the written slabs' row i
        return tuple(t[i:i + 1] for t in out)
    return out[i:i + 1]


@pytest.mark.parametrize("kind", Q8_KINDS)
@pytest.mark.parametrize("d,h", [(64, 12), (100, 8), (128, 8)])
def test_q8_split_kernels_are_batch_invariant_and_deterministic(dev, kind, d, h):
    """A row's output is the same bit for bit in a batch of 16 (per-slot
    positions on a grid over the whole cache), alone (an int position: a
    grid of its live chunks; a 1-row position tensor) and over 3 launches."""
    b, s = 16, 768
    c = _q8_positions(kind, d, s)
    pos_list = [c["chunk-1"], c["chunk"], c["chunk+1"], s - 1, 1, 2, 100, 255, 256, 300, 400,
                500, 575, 600, 700, 767]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    x = _q8_inputs(dev, b, s, h, d, True)
    full = _q8_run(kind, x, pos)
    for _ in range(2):
        assert _q8_equal(_q8_run(kind, x, pos), full)
    for i in (0, 1, 2, 3, 9, 15):
        alone = _q8_rows(x, [i])
        assert _q8_equal(_q8_run(kind, alone, pos_list[i]), _q8_row(full, i))
        assert _q8_equal(_q8_run(kind, alone, pos[i:i + 1].clone()), _q8_row(full, i))


def test_q8_split_counters_are_left_zero(dev):
    """Every launch leaves the arrival counters of its stream zero, across
    calls of different shapes, grids and kernels."""
    from controlar_tpu_torch.ops import _scratch

    for kind in Q8_KINDS:
        for b, h, d, pos in ((16, 12, 64, 575), (3, 3, 100, 40), (5, 4, 128, 767), (2, 12, 64, 1)):
            x = _q8_inputs(dev, b, 768, h, d, True)
            _q8_run(kind, x, pos)
            _q8_run(kind, x, torch.full((b,), pos, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, _ = _scratch._scratch[(torch.cuda.current_device(), stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kind", Q8_KINDS)
def test_q8_split_kernels_replay_in_a_cuda_graph(dev, kind):
    """One call captured with a device position vector, replayed after the
    vector changed in place, equals the eager call at the new positions."""
    b, s, h, d = 16, 768, 12, 64
    x = _q8_inputs(dev, b, s, h, d, False)
    pos = torch.tensor([1, 30, 31, 32, 100, 255, 256, 575] * 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the side stream's scratch, before the capture
        _q8_run(kind, x, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    if kind == "append":  # the graph writes its own copies of the slabs
        kv, sc = x["stack"][0].clone(), x["sc"][0].clone()
        with torch.cuda.graph(graph, stream=side):
            out = flash_decode_attention_q8_append(x["q"], x["new_kv"], x["new_s"], kv, sc, pos,
                                                   None, n_head=h)[0]
    else:
        with torch.cuda.graph(graph, stream=side):
            out = _q8_run(kind, x, pos)
    pos.copy_(torch.tensor([2, 31, 32, 33, 17, 511, 400, 767] * 2, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    if kind == "append":
        want, kv_want, sc_want = flash_decode_attention_q8_append(
            x["q"], x["new_kv"], x["new_s"], x["stack"][0].clone(), x["sc"][0].clone(), pos,
            None, n_head=h)
        assert torch.equal(kv, kv_want) and torch.equal(sc, sc_want)
    else:
        want = _q8_run(kind, x, pos)
    assert torch.equal(out, want)


# ---- the split bf16 kernels (B1, B12-bf16): chunk boundaries, batch ------
# ---- invariance, determinism, counters, CUDA-graph replay ----------------

BF16_KINDS = ("flat", "stacked")


def _bf16_inputs(dev, b, s, h, d, bias, seed=6):
    """q, a 2-layer bf16 stack, the in-flight row and a left-padded caption
    bias (row i's first 7 i columns, row 1's whole first chunk and 3 more)
    or None."""
    from controlar_tpu_torch.ops.flash_decode import CHUNK_ROWS

    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h * d, generator=g, device=dev) * 0.5).bfloat16()
    stack = (torch.randn(2, b, s, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    new_kv = (torch.randn(b, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7
        if b > 1:
            pad[1] = CHUNK_ROWS[torch.bfloat16][d] + 3
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    return dict(q=q, stack=stack, new_kv=new_kv, bias=col_bias)


def _bf16_run(kind, x, pos, plain=False):
    """The flat kernel (or plain version) on layer 0 of the stack, the
    stacked one on layer 1; the stacked call's bias is 0 at the in-flight
    row, as its callers keep it."""
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    b, s, n_head = x["q"].shape[0], x["stack"].shape[2], x["n_head"]
    cb = x["bias"]
    if kind == "flat":
        fn = flash_decode_attention_ref if plain else flash_decode_attention
        return fn(x["q"], x["stack"][0], pos, cb, n_head=n_head)
    if cb is not None:
        cb = cb.clone()
        p = torch.as_tensor(pos, device=cb.device).long().reshape(-1).expand(b)
        cb[torch.arange(b, device=cb.device), p.clamp(max=s - 1)] = 0.0
    fn = fds.flash_stacked_ref if plain else fds.flash_stacked
    return fn(x["q"], x["new_kv"], x["stack"], 1, pos, cb, n_head=n_head)


def _bf16_positions(d, s):
    """Positions on each side of a chunk boundary (the live rows, pos + 1,
    end one before, on and one after it), 0 (1 for the stacked call, as its
    callers clamp) and S - 1."""
    from controlar_tpu_torch.ops.flash_decode import CHUNK_ROWS

    c = CHUNK_ROWS[torch.bfloat16][d]
    return {"chunk-1": c - 2, "chunk": c - 1, "chunk+1": c, "zero": 0, "last": s - 1,
            "per_slot": [c - 2, c - 1, c, s - 1]}


@pytest.mark.parametrize("kind", BF16_KINDS)
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("pos", ["chunk-1", "chunk", "chunk+1", "zero", "last", "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_bf16_split_kernels_match_plain_versions(dev, kind, d, h, pos, bias):
    """H = 3 at D = 100 gives heads at 8-byte offsets (8-byte copies)."""
    b, s = 4, 768
    pos = _bf16_positions(d, s)[pos]
    if kind == "stacked" and pos == 0:
        pos = 1
    if isinstance(pos, list):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    x = dict(_bf16_inputs(dev, b, s, h, d, bias), n_head=h)
    got = _bf16_run(kind, x, pos)
    torch.cuda.synchronize()
    want = _bf16_run(kind, x, pos, plain=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("kind", BF16_KINDS)
@pytest.mark.parametrize("d,h", [(64, 12), (100, 8), (128, 8)])
def test_bf16_split_kernels_are_batch_invariant_and_deterministic(dev, kind, d, h):
    """A row's output is the same bit for bit in a batch of 16 (per-slot
    positions on a grid over the whole cache), alone (an int position: a
    grid of its live chunks; a 1-row position tensor) and over 3 launches."""
    b, s = 16, 768
    c = _bf16_positions(d, s)
    pos_list = [c["chunk-1"], c["chunk"], c["chunk+1"], s - 1, 1, 2, 100, 255, 256, 300, 400,
                500, 575, 600, 700, 767]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    x = dict(_bf16_inputs(dev, b, s, h, d, True), n_head=h)
    full = _bf16_run(kind, x, pos)
    for _ in range(2):
        assert torch.equal(_bf16_run(kind, x, pos), full)
    for i in (0, 1, 2, 3, 9, 15):
        alone = {k: v if k == "n_head" or v is None else
                 (v[:, [i]] if k == "stack" else v[[i]]).contiguous() for k, v in x.items()}
        assert torch.equal(_bf16_run(kind, alone, pos_list[i]), full[i:i + 1])
        assert torch.equal(_bf16_run(kind, alone, pos[i:i + 1].clone()), full[i:i + 1])


def test_bf16_split_counters_are_left_zero(dev):
    """Every launch leaves the arrival counters of its stream zero, across
    calls of different shapes, grids and kernels."""
    from controlar_tpu_torch.ops import _scratch

    for kind in BF16_KINDS:
        for b, h, d, pos in ((16, 12, 64, 575), (3, 3, 100, 40), (5, 4, 128, 767), (2, 12, 64, 1)):
            x = dict(_bf16_inputs(dev, b, 768, h, d, True), n_head=h)
            _bf16_run(kind, x, pos)
            _bf16_run(kind, x, torch.full((b,), pos, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, _ = _scratch._scratch[(torch.cuda.current_device(), stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kind", BF16_KINDS)
def test_bf16_split_kernels_replay_in_a_cuda_graph(dev, kind):
    """One call captured with a device position vector, replayed after the
    vector changed in place, equals the eager call at the new positions."""
    b, s, h, d = 16, 768, 12, 64
    x = dict(_bf16_inputs(dev, b, s, h, d, False), n_head=h)
    pos = torch.tensor([1, 62, 63, 64, 100, 255, 256, 575] * 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the side stream's scratch, before the capture
        _bf16_run(kind, x, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _bf16_run(kind, x, pos)
    pos.copy_(torch.tensor([2, 63, 64, 65, 17, 511, 400, 767] * 2, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _bf16_run(kind, x, pos))


# ---- the split int4 kernels (B3, B12-q4): chunk boundaries, batch ----------
# ---- invariance, determinism, counters, CUDA-graph replay -----------------

Q4_KINDS = ("flat", "stacked")


def _q4_inputs(dev, b, s, h, d, split, bias, seed=7):
    """q, a 2-layer int4 stack and its scales, the in-flight row and its
    scales, and a left-padded caption bias (row i's first 7 i columns, row
    1's whole first chunk and 3 more) or None."""
    from controlar_tpu_torch.ops.flash_decode import CHUNK_ROWS, INT4

    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h * d, generator=g, device=dev) * 0.5).bfloat16()
    stack, sc = quantize_kv_rows_4(torch.randn(2, b, s, 2 * h * d, generator=g, device=dev) * 0.5,
                                   h, split=split)
    new_c, new_s = quantize_kv_rows_4(torch.randn(b, 2 * h * d, generator=g, device=dev) * 0.5, h,
                                      split=split)
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7
        if b > 1:
            pad[1] = CHUNK_ROWS[INT4][d] + 3
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    return dict(q=q, stack=stack, sc=sc, new_c=new_c, new_s=new_s, bias=col_bias,
                kw=dict(n_head=h, head_dim=d, split=split))


def _q4_run(kind, x, pos, plain=False):
    """The flat kernel (or plain version) on layer 0 of the stack, the
    stacked one on layer 1; the stacked call's bias is 0 at the in-flight
    row, as its callers keep it."""
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    b, s = x["q"].shape[0], x["stack"].shape[2]
    cb = x["bias"]
    if kind == "flat":
        fn = flash_decode_attention_q4_ref if plain else flash_decode_attention_q4
        return fn(x["q"], x["stack"][0], x["sc"][0], pos, cb, **x["kw"])
    if cb is not None:
        cb = cb.clone()
        p = torch.as_tensor(pos, device=cb.device).long().reshape(-1).expand(b)
        cb[torch.arange(b, device=cb.device), p.clamp(max=s - 1)] = 0.0
    fn = fds.flash_stacked_q4_ref if plain else fds.flash_stacked_q4
    return fn(x["q"], x["new_c"], x["new_s"], x["stack"], x["sc"], 1, pos, cb, **x["kw"])


def _q4_rows(x, rows):
    """The inputs of the batch rows `rows` alone."""
    return {k: v if k == "kw" or v is None else
            (v[:, rows] if k in ("stack", "sc") else v[rows]).contiguous() for k, v in x.items()}


def _q4_positions(d, s):
    """Positions on each side of a boundary of the int4 kernels' chunks (the
    live rows, pos + 1, end one before, on and one after it), 0 (1 for the
    stacked call, as its callers clamp) and S - 1."""
    from controlar_tpu_torch.ops.flash_decode import CHUNK_ROWS, INT4

    c = CHUNK_ROWS[INT4][d]
    return {"chunk-1": c - 2, "chunk": c - 1, "chunk+1": c, "zero": 0, "last": s - 1,
            "per_slot": [c - 2, c - 1, c, s - 1]}


@pytest.mark.parametrize("kind", Q4_KINDS)
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("pos", ["chunk-1", "chunk", "chunk+1", "zero", "last", "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_q4_split_kernels_match_plain_versions(dev, kind, d, h, pos, bias, split):
    """H = 3 at D = 100 puts the rows' 50-byte head spans at every even
    offset of their 16-byte windows (300-byte rows)."""
    b, s = 4, 768
    pos = _q4_positions(d, s)[pos]
    if kind == "stacked" and pos == 0:
        pos = 1
    if isinstance(pos, list):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    x = _q4_inputs(dev, b, s, h, d, split, bias)
    got = _q4_run(kind, x, pos)
    torch.cuda.synchronize()
    want = _q4_run(kind, x, pos, plain=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("kind", Q4_KINDS)
def test_q4_split_kernels_take_slabs_at_an_8_byte_offset(dev, kind):
    """At D = 100 the wrappers take 8-byte aligned slabs: every span's
    window offset moves by 8."""
    b, s, h, d = 4, 768, 3, 100
    x = _q4_inputs(dev, b, s, h, d, True, True)
    for name in ("stack", "new_c"):
        t = x[name]
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        x[name] = buf[8:].view(t.shape)
        x[name].copy_(t)
        assert x[name].data_ptr() % 16 == 8
    pos = torch.tensor([1, 31, 32, 767], dtype=torch.int32, device=dev)
    got = _q4_run(kind, x, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), _q4_run(kind, x, pos, plain=True).float(), atol=2e-3,
                               rtol=1e-2)


@pytest.mark.parametrize("kind", Q4_KINDS)
@pytest.mark.parametrize("d,h,split", [(64, 12, False), (100, 8, True), (100, 3, False),
                                       (128, 8, True)])
def test_q4_split_kernels_are_batch_invariant_and_deterministic(dev, kind, d, h, split):
    """A row's output is the same bit for bit in a batch of 16 (per-slot
    positions on a grid over the whole cache), alone (an int position: a
    grid of its live chunks; a 1-row position tensor) and over 3 launches."""
    b, s = 16, 768
    c = _q4_positions(d, s)
    pos_list = [c["chunk-1"], c["chunk"], c["chunk+1"], s - 1, 1, 2, 100, 255, 256, 300, 400,
                500, 575, 600, 700, 767]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    x = _q4_inputs(dev, b, s, h, d, split, True)
    full = _q4_run(kind, x, pos)
    for _ in range(2):
        assert torch.equal(_q4_run(kind, x, pos), full)
    for i in (0, 1, 2, 3, 9, 15):
        alone = _q4_rows(x, [i])
        assert torch.equal(_q4_run(kind, alone, pos_list[i]), full[i:i + 1])
        assert torch.equal(_q4_run(kind, alone, pos[i:i + 1].clone()), full[i:i + 1])


def test_q4_split_counters_are_left_zero(dev):
    """Every launch leaves the arrival counters of its stream zero, across
    calls of different shapes, grids and kernels."""
    from controlar_tpu_torch.ops import _scratch

    for kind in Q4_KINDS:
        for b, h, d, pos in ((16, 12, 64, 575), (3, 3, 100, 40), (5, 4, 128, 767), (2, 32, 100, 1)):
            x = _q4_inputs(dev, b, 768, h, d, d == 100, True)
            _q4_run(kind, x, pos)
            _q4_run(kind, x, torch.full((b,), pos, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, _ = _scratch._scratch[(torch.cuda.current_device(), stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kind", Q4_KINDS)
@pytest.mark.parametrize("d,h,split", [(64, 12, False), (100, 32, True)])
def test_q4_split_kernels_replay_in_a_cuda_graph(dev, kind, d, h, split):
    """One call captured with a device position vector, replayed after the
    vector changed in place, equals the eager call at the new positions."""
    b, s = 16, 768
    x = _q4_inputs(dev, b, s, h, d, split, False)
    pos = torch.tensor([1, 30, 31, 32, 100, 255, 256, 575] * 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the side stream's scratch, before the capture
        _q4_run(kind, x, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _q4_run(kind, x, pos)
    pos.copy_(torch.tensor([2, 63, 64, 65, 17, 511, 400, 767] * 2, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _q4_run(kind, x, pos))


# ---- W4 weights: the dequant-matmul and the fused FFN ---------------------

def _w4(dev, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quantize_weight_w4(torch.randn(k, n, generator=g, device=dev) * 0.05)


def _x(dev, b, k, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, k, generator=g, device=dev) * 0.5).bfloat16()


# K = 3200: 25 planes, the odd tail; K = 200: not a group multiple (x padded)
@pytest.mark.parametrize("rows", [1, 16, 17, 64, 256])
@pytest.mark.parametrize("k", [3200, 256, 200])
def test_w4_matmul_matches_plain_version(dev, rows, k):
    q4, s = _w4(dev, k, 384, seed=k)
    x = _x(dev, rows, k)
    out = w4_matmul(x, q4, s, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = w4_matmul_ref(x, q4, s, torch.float32)
    # fp32 sums in another order (|out| ~ 1); a dropped plane moves it by ~0.1
    torch.testing.assert_close(out, want, atol=1e-3, rtol=1e-4)
    bf = w4_matmul(x, q4, s)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("rows", [1, 16, 17, 40, 64, 256])
@pytest.mark.parametrize("shape", [(384, 640, 256), (3200, 8704, 3200)])
def test_w4_ffn_matches_plain_version(dev, rows, shape):
    k, f, n = shape
    q13, s13 = _w4(dev, k, 2 * f, seed=1)
    q2, s2 = _w4(dev, f, n, seed=2)
    x = _x(dev, rows, k)
    out = w4_ffn(x, q13, s13, q2, s2, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = w4_ffn_ref(x, q13, s13, q2, s2, torch.float32)
    # z is rounded to bf16 on both sides; an fp32 difference that flips one
    # rounding (|z| up to ~8 here, a step of 0.03) moves an output by up to
    # ~5e-3 at these weights (std 0.05); a dropped plane of w2 moves it by ~0.5
    torch.testing.assert_close(out, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("bad", ["group", "dtype", "noncontig", "k_too_long"])
def test_w4_matmul_rejects(dev, bad):
    q4, s = _w4(dev, 256, 128, seed=0)
    x = _x(dev, 4, 256)
    if bad == "group":
        s = torch.cat([s, s])  # group 64
    elif bad == "dtype":
        q4 = q4.to(torch.int16)
    elif bad == "noncontig":
        q4 = torch.cat([q4, q4], dim=1)[:, ::2]
    else:
        x = _x(dev, 4, 512)
    with pytest.raises(ValueError):
        w4_matmul(x, q4, s)


def test_w4_ffn_rejects_an_unfused_shape(dev):
    q13, s13 = _w4(dev, 200, 512, seed=0)  # K = 200 is not a group multiple
    q2, s2 = _w4(dev, 256, 128, seed=1)
    with pytest.raises(ValueError):
        w4_ffn(_x(dev, 4, 200), q13, s13, q2, s2)


def test_w4_launch_counts(dev):
    q13, s13 = _w4(dev, 256, 512, seed=0)
    q2, s2 = _w4(dev, 256, 128, seed=1)
    x = _x(dev, 4, 256)
    w4_matmul.launches = w4_ffn.launches = 0
    w4_matmul(x, q13, s13)
    w4_ffn(x, q13, s13, q2, s2)
    w4_ffn(x, q13, s13, q2, s2)
    assert (w4_matmul.launches, w4_ffn.launches) == (1, 2)


# GPT-3B widths: wqkv (N 9600, 75 column tiles) and wo (N 3200, split K)
@pytest.mark.parametrize("rows", [1, 16, 17, 64, 256])
@pytest.mark.parametrize("k,n", [(3200, 3200), (3200, 9600), (200, 3200)])
def test_w4_matmul_matches_plain_version_at_3b_widths(dev, rows, k, n):
    q4, s = _w4(dev, k, n, seed=n + k)
    x = _x(dev, rows, k)
    out = w4_matmul(x, q4, s)
    torch.cuda.synchronize()
    want = w4_matmul_ref(x, q4, s, torch.float32)
    # bf16 outputs (step 2**-7 relative) over fp32 sums in another order
    torch.testing.assert_close(out.float(), want, atol=1e-2, rtol=1e-2)


def _w4_ffn_weights(dev, k=3200, f=8704, n=3200):
    return (*_w4(dev, k, 2 * f, seed=1), *_w4(dev, f, n, seed=2))


@pytest.mark.parametrize("kind", ["wo", "wqkv", "ffn"])
def test_w4_kernels_are_deterministic(dev, kind):
    """Two launches on the same inputs agree bit for bit (the split-K sums
    run in a fixed order, with no float atomics)."""
    if kind == "ffn":
        w = _w4_ffn_weights(dev)
        run = lambda x: w4_ffn(x, *w, out_dtype=torch.float32)  # noqa: E731
    else:
        q4, s = _w4(dev, 3200, 3200 if kind == "wo" else 9600, seed=5)
        run = lambda x: w4_matmul(x, q4, s, out_dtype=torch.float32)  # noqa: E731
    for rows in (16, 64):
        x = _x(dev, rows, 3200)
        assert torch.equal(run(x), run(x))


@pytest.mark.parametrize("kind", ["wo", "wqkv", "ffn"])
def test_w4_kernels_are_batch_invariant(dev, kind):
    """Row i of a 64-row call (the speculative verify) equals the same row
    run alone and within a 16-row call (decode), bit for bit."""
    if kind == "ffn":
        w = _w4_ffn_weights(dev)
        run = lambda x: w4_ffn(x, *w, out_dtype=torch.float32)  # noqa: E731
    else:
        q4, s = _w4(dev, 3200, 3200 if kind == "wo" else 9600, seed=6)
        run = lambda x: w4_matmul(x, q4, s, out_dtype=torch.float32)  # noqa: E731
    x = _x(dev, 64, 3200)
    full = run(x)
    assert torch.equal(run(x[16:32].contiguous()), full[16:32])
    for i in (0, 17, 63):
        assert torch.equal(run(x[i:i + 1].contiguous()), full[i:i + 1])


# ---- the per-slot KV-cache row append --------------------------------------

# (dtype, row width): GPT-B bf16 [k|v] rows and int8 rows, 12-head f32 scales,
# GPT-3B int4 carriers (3200 B) and 32-head scales, 3-head scales (24 B: an
# 8-byte vector), an odd byte width (1-byte vectors)
APPEND_STREAMS = [(torch.bfloat16, 1536), (torch.int8, 1536), (torch.float32, 24),
                  (torch.int8, 3200), (torch.float32, 64), (torch.float32, 6), (torch.int8, 7)]


@pytest.mark.parametrize("dtype,width", APPEND_STREAMS)
def test_cache_append_matches_plain_version(dev, dtype, width):
    from controlar_tpu_torch.ops.cache_append import cache_append_rows, cache_append_rows_ref

    b, s = 16, 768
    g = torch.Generator(device=dev).manual_seed(width)
    if dtype == torch.int8:
        cache = torch.randint(-128, 128, (b, s, width), generator=g, device=dev, dtype=dtype)
        rows = torch.randint(-128, 128, (b, width), generator=g, device=dev, dtype=dtype)
    else:
        cache = torch.randn(b, s, width, generator=g, device=dev).to(dtype)
        rows = torch.randn(b, width, generator=g, device=dev)  # cast by the wrapper
    pos = torch.tensor([0, s - 1] + [7 * i + 3 for i in range(b - 2)], dtype=torch.int32,
                       device=dev)
    want = cache_append_rows_ref(cache.clone(), rows, pos)
    before = cache_append_rows.launches
    out = cache_append_rows(cache, rows, pos)
    torch.cuda.synchronize()
    assert out is cache and cache_append_rows.launches == before + 1
    assert torch.equal(cache.view(torch.uint8), want.view(torch.uint8))


def test_cache_append_skips_out_of_range_rows(dev):
    from controlar_tpu_torch.ops.cache_append import cache_append_rows

    cache = torch.zeros(3, 8, 16, dtype=torch.bfloat16, device=dev)
    rows = torch.ones(3, 16, device=dev)
    cache_append_rows(cache, rows, torch.tensor([-1, 8, 2], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert cache[:2].abs().sum().item() == 0 and cache[2, 2].float().sum().item() == 16


@pytest.mark.parametrize("bad", ["pos_dtype", "rows_shape", "noncontig"])
def test_cache_append_rejects(dev, bad):
    from controlar_tpu_torch.ops.cache_append import cache_append_rows

    cache = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device=dev)
    rows = torch.ones(2, 16, device=dev)
    pos = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "rows_shape":
        rows = rows[:, :8]
    else:
        cache = torch.zeros(2, 16, 16, dtype=torch.bfloat16, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        cache_append_rows(cache, rows, pos)


# ---- the fused KV write: a layer's new k / v rows into every stream ----------

def _kv_write_case(dev, kind, t, d, layout, dtype, b=16, s=768, kvh=4, seed=0):
    """A cache of `kind` with random contents and new rows k, v (b, t, kvh*d)
    as the projections leave them: v a slice of a wqkv output, k a slice of
    the rotated [q|k] (layout "qkv_split") or a contiguous tensor; a head of
    zeros and an outlier head."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = kvh * d
    v = (torch.randn(b, t, 3 * kvd, generator=g, device=dev) * 2).to(dtype)[..., 2 * kvd:]
    if layout == "qkv_split":
        k = (torch.randn(b, t, 2 * kvd, generator=g, device=dev) * 2).to(dtype)[..., kvd:]
    else:
        k = (torch.randn(b, t, kvd, generator=g, device=dev) * 2).to(dtype)
    k[0, 0, :d] = 0
    v[1, -1, d:2 * d] *= 1000
    if kind in ("bf16", "f32"):
        cache = torch.randn(b, s, 2 * kvd, generator=g, device=dev).to(
            torch.bfloat16 if kind == "bf16" else torch.float32)
    else:
        key, width = ("kv", 2 * kvd) if kind == "int8" else ("kv4", kvd)
        cache = {key: torch.randint(-128, 128, (b, s, width), generator=g, device=dev,
                                    dtype=torch.int8),
                 "s": torch.rand(b, s, 2 * kvh, generator=g, device=dev) * 0.02}
    return cache, k, v, kvh


def _clone(cache):
    return {k: t.clone() for k, t in cache.items()} if isinstance(cache, dict) else cache.clone()


def _assert_same(got, want):
    if isinstance(got, dict):
        for key in got:
            assert torch.equal(got[key].view(torch.uint8), want[key].view(torch.uint8)), key
    else:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int4", "int4_split"])
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("layout", ["qkv", "qkv_split"])
@pytest.mark.parametrize("pos", ["rows", "int"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_append_kv_matches_plain_version(dev, kind, t, d, layout, pos, dtype):
    """The fused write against its plain version (concatenation, the port's
    quantizer, one indexed or slice assignment per stream), bit for bit, on
    every stream."""
    from controlar_tpu_torch.ops.cache_append import append_kv, append_kv_ref

    cache, k, v, kvh = _kv_write_case(dev, kind, t, d, layout, dtype)
    s = cache.shape[1] if kind in ("bf16", "f32") else cache["s"].shape[1]
    split = kind == "int4_split"
    if pos == "rows":
        pos = torch.tensor([0, s - t] + [37 * i + 3 for i in range(14)], dtype=torch.int32,
                           device=dev)
    else:
        pos = s - t
    want = append_kv_ref(_clone(cache), k, v, pos, kv_heads=kvh, split=split)
    before = append_kv.launches
    out = append_kv(cache, k, v, pos, kv_heads=kvh, split=split)
    torch.cuda.synchronize()
    assert out is cache and append_kv.launches == before + 1
    _assert_same(cache, want)


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_split"])
def test_append_kv_nan_and_inf_match_plain_version(dev, kind):
    """Non-finite values: a NaN head's scale stays NaN and its values store
    0, as the plain version's clamp and cast do on the card; an inf head's
    scale is inf."""
    from controlar_tpu_torch.ops.cache_append import append_kv, append_kv_ref

    cache, k, v, kvh = _kv_write_case(dev, kind, 1, 64, "qkv", torch.bfloat16)
    k[2, 0, 5] = float("nan")
    v[3, 0, 64 + 7] = float("inf")
    v[4, 0, 9] = float("-inf")
    pos = torch.arange(16, dtype=torch.int32, device=dev) * 3
    want = append_kv_ref(_clone(cache), k, v, pos, kv_heads=kvh, split=kind == "int4_split")
    append_kv(cache, k, v, pos, kv_heads=kvh, split=kind == "int4_split")
    torch.cuda.synchronize()
    _assert_same(cache, want)
    assert torch.isnan(cache["s"][2, 6, 0]) and torch.isinf(cache["s"][3, 9, kvh + 1])


def test_append_kv_skips_out_of_range_rows(dev):
    from controlar_tpu_torch.ops.cache_append import append_kv

    cache = torch.zeros(3, 8, 2 * 2 * 64, dtype=torch.bfloat16, device=dev)
    k = torch.ones(3, 2, 2 * 64, device=dev)
    v = torch.ones(3, 2, 2 * 64, device=dev)
    append_kv(cache, k, v, torch.tensor([-1, 7, 2], dtype=torch.int32, device=dev), kv_heads=2)
    torch.cuda.synchronize()
    assert cache[:2].abs().sum().item() == 0 and cache[2, 2:4].float().sum().item() == 2 * 256
    append_kv(cache, k, v, 7, kv_heads=2)
    torch.cuda.synchronize()
    assert cache[:, 7].abs().sum().item() == 0


def test_append_kv_under_a_cuda_graph(dev):
    """The fused write replays under a CUDA graph, reading pos on the device."""
    from controlar_tpu_torch.ops.cache_append import append_kv, append_kv_ref

    cache, k, v, kvh = _kv_write_case(dev, "int8", 1, 64, "qkv", torch.bfloat16)
    pos = torch.zeros(16, dtype=torch.int32, device=dev)
    want = _clone(cache)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        append_kv(cache, k, v, pos, kv_heads=kvh)  # warm: the library is loaded
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        append_kv(cache, k, v, pos, kv_heads=kvh)
    for p in (5, 300):
        pos.fill_(p)
        graph.replay()
        append_kv_ref(want, k, v, pos, kv_heads=kvh)
    torch.cuda.synchronize()
    append_kv_ref(want, k, v, torch.zeros_like(pos), kv_heads=kvh)
    _assert_same(cache, want)


def test_serve_slot_isolation_on_the_card(dev):
    """Request 0 alone and with a neighbour admitted one step() later: the
    same sampled tokens, through the kernels (flash decode, fused KV write)."""
    from controlar_tpu_torch.cells import serve_requests, serve_staggered
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.ops.cache_append import append_kv
    from controlar_tpu_torch.serve import ServeConfig, ServeEngine

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device=dev)

    def run(n):
        eng = ServeEngine(model, cfg, ServeConfig(max_slots=2, quantum=6, top_k=8), device=dev)
        return serve_staggered(eng, serve_requests(n, num_classes=10), upfront=1,
                               add_after_step=1)

    before = append_kv.launches
    solo, duo = run(1), run(2)
    assert append_kv.launches > before
    np.testing.assert_array_equal(solo[0].tokens, duo[0].tokens)
    assert not np.array_equal(duo[0].tokens, duo[1].tokens)


def test_serve_engine_refuses_the_plain_route_on_the_card(dev):
    """use_flash=False on the card is taken only by a model the attention
    kernels cannot take (kv_heads != n_head)."""
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.serve import ServeConfig, ServeEngine

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=1, n_head=2, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        ServeEngine(model, cfg, ServeConfig(max_slots=2, use_flash=False), device=dev)


# ---- speculative decode: chunk attention and the block append -----------------

def _chunk_inputs(dev, b, s, h, d, k, bias, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, k, h * d, generator=g, device=dev) * 0.5).bfloat16()
    kv = (torch.randn(b, s, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    col_bias = None
    if bias:  # left padding; row 0's chunk at pos 0 masks its own rows
        pad = torch.arange(b, device=dev)[:, None] * 7 + 3
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    pos = torch.tensor([0, 1, 254, 255, 300, 572][:b], dtype=torch.int32, device=dev)
    return q, kv, pos, col_bias


@pytest.mark.parametrize("kind", ["bf16", "q8", "q4", "q4_split"])
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("k", [1, 3, 4, 8, 20])
@pytest.mark.parametrize("bias", [False, True])
def test_chunk_kernel_matches_plain_version(dev, kind, d, k, bias):
    from controlar_tpu_torch.ops import flash_chunk as fc

    h = 3
    q, kv, pos, col_bias = _chunk_inputs(dev, 6, 768, h, d, k, bias, seed=d + k)
    if kind == "bf16":
        args, kw = (kv,), {}
        kern, ref = fc.flash_chunk_attention, fc.flash_chunk_attention_ref
    elif kind == "q8":
        args, kw = quantize_kv_rows(kv, h), {}
        kern, ref = fc.flash_chunk_attention_q8, fc.flash_chunk_attention_q8_ref
    else:
        split = kind == "q4_split"
        args, kw = quantize_kv_rows_4(kv, h, split=split), dict(head_dim=d, split=split)
        kern, ref = fc.flash_chunk_attention_q4, fc.flash_chunk_attention_q4_ref
    before = kern.launches
    out = kern(q, *args, pos, col_bias, n_head=h, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and out.shape == q.shape and out.dtype == q.dtype
    want = ref(q, *args, pos, col_bias, n_head=h, **kw)
    err = (out.float() - want.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= 2e-3 + 1e-2 * want.float().abs()).all()), err.max().item()


def test_chunk_f32_query_gives_f32_output(dev):
    from controlar_tpu_torch.ops.flash_chunk import (
        flash_chunk_attention, flash_chunk_attention_ref)

    q, kv, pos, _ = _chunk_inputs(dev, 4, 256, 2, 64, 4, False)
    out = flash_chunk_attention(q.float(), kv, pos, n_head=2)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, flash_chunk_attention_ref(q.float(), kv, pos, n_head=2),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", ["q_shape", "pos_dtype", "bias_dtype", "head_dim"])
def test_chunk_wrapper_rejects(dev, bad):
    from controlar_tpu_torch.ops.flash_chunk import flash_chunk_attention

    q, kv, pos, bias = _chunk_inputs(dev, 4, 256, 2, 64, 4, True)
    h = 2
    if bad == "q_shape":
        q = q[:, 0]
    elif bad == "pos_dtype":
        pos = pos.long()
    elif bad == "bias_dtype":
        bias = bias.bfloat16()
    else:
        kv, q, h = kv[..., :96].contiguous(), q[..., :48].contiguous(), 2
    with pytest.raises(ValueError):
        flash_chunk_attention(q, kv, pos, bias, n_head=h)


# ---- the split chunk kernels (B7 bf16 / int8, B8 int4): chunk boundaries, ----
# ---- batch invariance, determinism, counters, CUDA-graph replay ------------

CHUNK_KINDS = ("bf16", "q8", "q4", "q4_split")


def _chunk_split_inputs(dev, kind, b, s, h, d, k, bias, seed=8):
    """q, the kind's slab and the plain version's arguments, and a
    left-padded caption bias (row i's first 7 i + 3 columns, row 1's whole
    first chunk and 3 rows more) or None."""
    from controlar_tpu_torch.ops import flash_chunk as fc

    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, k, h * d, generator=g, device=dev) * 0.5).bfloat16()
    kv = (torch.randn(b, s, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    if kind == "bf16":
        args, kw = (kv,), {}
    elif kind == "q8":
        args, kw = quantize_kv_rows(kv, h), {}
    else:
        split = kind == "q4_split"
        args, kw = quantize_kv_rows_4(kv, h, split=split), dict(head_dim=d, split=split)
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7 + 3
        if b > 1:
            pad[1] = fc.CHUNK_ROWS + 3
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    return dict(q=q, args=args, kw=kw, bias=col_bias, n_head=h, chunk=fc.CHUNK_ROWS)


def _chunk_split_run(kind, x, pos, plain=False, rows=None):
    """The kind's kernel (or plain version) on x, or on batch rows `rows`."""
    from controlar_tpu_torch.ops import flash_chunk as fc

    kern, ref = {"bf16": (fc.flash_chunk_attention, fc.flash_chunk_attention_ref),
                 "q8": (fc.flash_chunk_attention_q8, fc.flash_chunk_attention_q8_ref)}.get(
        kind, (fc.flash_chunk_attention_q4, fc.flash_chunk_attention_q4_ref))
    q, args, bias = x["q"], x["args"], x["bias"]
    if rows is not None:
        q, args = q[rows].contiguous(), tuple(a[rows].contiguous() for a in args)
        bias = None if bias is None else bias[rows].contiguous()
    return (ref if plain else kern)(q, *args, pos, bias, n_head=x["n_head"], **x["kw"])


def _chunk_split_positions(chunk, k, s):
    """Base positions whose last query's visible rows (pos + K) end one
    before, on and one after a chunk boundary, 0 and the last in the cache."""
    return {"chunk-1": max(chunk - 1 - k, 0), "chunk": max(chunk - k, 0),
            "chunk+1": max(chunk + 1 - k, 0), "zero": 0, "last": s - k}


@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("h", [3, 4])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("bias", [False, True])
def test_chunk_split_kernels_match_plain_versions(dev, kind, d, h, k, bias):
    """Each boundary position as an int, then all of them and rows whose
    last query is one past the cache as a per-row tensor. H = 3 at D = 100
    puts the head spans at 8-, 4- and 2-byte offsets (the copy windows)."""
    b, s = 6, 320
    x = _chunk_split_inputs(dev, kind, b, s, h, d, k, bias)
    at = _chunk_split_positions(x["chunk"], k, s)
    per_row = torch.tensor(list(at.values()) + [s - k + 1], dtype=torch.int32, device=dev)
    for pos in [*at.values(), per_row]:
        got = _chunk_split_run(kind, x, pos)
        torch.cuda.synchronize()
        want = _chunk_split_run(kind, x, pos, plain=True)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_chunk_split_kernels_match_plain_versions_at_the_prefill_chunk(dev, kind):
    """The 120-query prefill chunk (15 tiles of 8) at t2i widths, at 0 and
    past a chunk boundary, with the caption bias."""
    b, s, h, d, k = 4, 384, 20, 64, 120
    x = _chunk_split_inputs(dev, kind, b, s, h, d, k, True)
    for pos in (0, 130, torch.tensor([0, 1, 64, 200], dtype=torch.int32, device=dev)):
        got = _chunk_split_run(kind, x, pos)
        torch.cuda.synchronize()
        want = _chunk_split_run(kind, x, pos, plain=True)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("d,h,k", [(64, 12, 4), (100, 8, 4), (100, 8, 8), (128, 8, 1)])
def test_chunk_split_kernels_are_batch_invariant_and_deterministic(dev, kind, d, h, k):
    """A row's output is the same bit for bit in a batch of 16 (per-row
    positions on a grid over the whole cache), alone (an int position: a
    grid of its live chunks; a 1-row position tensor) and over 3 launches."""
    b, s = 16, 768
    x = _chunk_split_inputs(dev, kind, b, s, h, d, k, True)
    at = _chunk_split_positions(x["chunk"], k, s)
    pos_list = [*at.values(), 1, 2, 100, 255, 256, 300, 400, 500, 572, 600, 700]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    full = _chunk_split_run(kind, x, pos)
    for _ in range(2):
        assert torch.equal(_chunk_split_run(kind, x, pos), full)
    for i in (0, 1, 2, 3, 9, 15):
        assert torch.equal(_chunk_split_run(kind, x, pos_list[i], rows=[i]), full[i:i + 1])
        assert torch.equal(_chunk_split_run(kind, x, pos[i:i + 1].clone(), rows=[i]),
                           full[i:i + 1])


def test_chunk_split_counters_are_left_zero(dev):
    """Every launch leaves the arrival counters of its stream zero, across
    kinds, shapes, tiles and grids."""
    from controlar_tpu_torch.ops import _scratch

    for kind in CHUNK_KINDS:
        for b, h, d, k, pos in ((16, 12, 64, 4, 572), (3, 3, 100, 8, 40), (5, 4, 128, 3, 700),
                                (2, 12, 64, 120, 0), (2, 4, 100, 1, 1)):
            x = _chunk_split_inputs(dev, kind, b, 768, h, d, k, True)
            _chunk_split_run(kind, x, pos)
            _chunk_split_run(kind, x, torch.full((b,), pos, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, _ = _scratch._scratch[(torch.cuda.current_device(), stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_chunk_split_kernels_replay_in_a_cuda_graph(dev, kind):
    """One call captured with a device position vector, replayed after the
    vector changed in place, equals the eager call at the new positions; the
    capturing stream's counters are zero after it."""
    from controlar_tpu_torch.ops import _scratch

    b, s, h, d, k = 16, 768, 32, 100, 4
    x = _chunk_split_inputs(dev, kind, b, s, h, d, k, False)
    pos = torch.tensor([1, 27, 28, 29, 100, 255, 256, 572] * 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the side stream's scratch, before the capture
        _chunk_split_run(kind, x, pos)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _chunk_split_run(kind, x, pos)
    pos.copy_(torch.tensor([2, 28, 29, 30, 17, 511, 400, 760] * 2, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _chunk_split_run(kind, x, pos))
    counters, _ = _scratch._scratch[(torch.cuda.current_device(), side.cuda_stream)]
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 6400), (torch.int8, 6400),
                                         (torch.float32, 64), (torch.int8, 3200),
                                         (torch.float32, 6), (torch.int8, 7)])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_cache_append_block_matches_plain_version(dev, dtype, width, k):
    from controlar_tpu_torch.ops.cache_append import cache_append_block, cache_append_block_ref

    b, s = 16, 768
    g = torch.Generator(device=dev).manual_seed(width + k)
    if dtype == torch.int8:
        cache = torch.randint(-128, 128, (b, s, width), generator=g, device=dev, dtype=dtype)
        rows = torch.randint(-128, 128, (b, k, width), generator=g, device=dev, dtype=dtype)
    else:
        cache = torch.randn(b, s, width, generator=g, device=dev).to(dtype)
        rows = torch.randn(b, k, width, generator=g, device=dev)  # cast by the wrapper
    pos = torch.tensor([0, s - k] + [37 * i + 3 for i in range(b - 2)], dtype=torch.int32,
                       device=dev)
    want = cache_append_block_ref(cache.clone(), rows, pos)
    before = cache_append_block.launches
    out = cache_append_block(cache, rows, pos)
    torch.cuda.synchronize()
    assert out is cache and cache_append_block.launches == before + 1
    assert torch.equal(cache.view(torch.uint8), want.view(torch.uint8))


def test_cache_append_block_skips_blocks_outside_the_cache(dev):
    from controlar_tpu_torch.ops.cache_append import cache_append_block

    cache = torch.zeros(3, 8, 16, dtype=torch.bfloat16, device=dev)
    rows = torch.ones(3, 4, 16, device=dev)
    cache_append_block(cache, rows, torch.tensor([-1, 5, 4], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert cache[:2].abs().sum().item() == 0 and cache[2, 4:].float().sum().item() == 64


def test_spec_greedy_equals_plain_greedy_on_the_card(dev):
    """Greedy speculative decode through the kernels gives the plain greedy
    loop's tokens (small fp32 model, no control features)."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch import spec_decode as tspec
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.ops.cache_append import append_kv
    from controlar_tpu_torch.ops.flash_chunk import flash_chunk_attention

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, device=dev)
    draft = tgpt.init_gpt(cfg, seed=1, device=dev)
    kw = dict(labels=torch.arange(3, device=dev), max_new_tokens=16, cfg_scale=2.0, device=dev)
    before = (flash_chunk_attention.launches, append_kv.launches)
    spec, stats = tspec.generate_spec(model, cfg, draft, return_stats=True, **kw)
    assert flash_chunk_attention.launches - before[0] == cfg.n_layer * stats["loop_iters"]
    # each cycle: k = 4 draft steps and the verify, one fused write a layer each
    assert append_kv.launches - before[1] == 5 * cfg.n_layer * stats["loop_iters"]
    plain = tgen.generate(model, cfg, sample_logits=False, **kw)
    assert torch.equal(spec, plain)
    with pytest.raises(ValueError, match="use_flash=False"):
        tspec.generate_spec(model, cfg, draft, use_flash=False, **kw)


# ---- training: the flash attention kernels and one control train step ----

# as chip_smoke's TRAIN_ATOL / TRAIN_RTOL: p rounded to bf16 against the
# running max (kernel) or the row max (plain), bf16 outputs; dq, dk, dv sum
# bf16-rounded terms in another order
_TRAIN_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("t", [1, 63, 200])
@pytest.mark.parametrize("bias", [False, True])
def test_flash_train_kernels_match_plain_versions(dev, d, t, bias):
    from controlar_tpu_torch.ops import flash_train as ft

    g = torch.Generator(device=dev).manual_seed(t + d)
    b, h = 2, 3
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=dev).bfloat16() for _ in range(4))
    valid = torch.ones(b, t, dtype=torch.bool, device=dev)
    if bias:
        valid[0, : t // 3] = False  # left-padded caption columns
    do = do * valid[:, :, None, None]  # the fully masked rows' cotangent is zero
    kb = ft.key_bias(valid) if bias else None
    out_ref, lse_ref = ft.flash_train_fwd_ref(q, k, v, kb)
    delta = (do.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    out, lse = ft.flash_train_fwd(q, k, v, kb)
    dq = ft.flash_train_dq(q, k, v, kb, do, lse_ref, delta)
    dk, dv = ft.flash_train_dkv(q, k, v, kb, do, lse_ref, delta)
    torch.cuda.synchronize()
    rows = valid[:, :, None, None]
    torch.testing.assert_close((out * rows).float(), (out_ref * rows).float(), **_TRAIN_TOL)
    lrows = valid[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], lse_ref[lrows], atol=1e-3, rtol=1e-4)
    for got, want in zip((dq, dk, dv), ft.flash_train_bwd_ref(q, k, v, kb, do, lse_ref, delta)):
        torch.testing.assert_close(got.float(), want.float(), **_TRAIN_TOL)


def test_flash_train_kernels_are_deterministic_and_take_f32(dev):
    from controlar_tpu_torch.ops import flash_train as ft

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(2, 150, 3, 64, generator=g, device=dev) for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    runs = []
    for _ in range(2):
        out = ft.flash_attention_train(q, k, v)
        runs.append((out, *torch.autograd.grad(out, (q, k, v), do)))
    assert all(x.dtype == torch.float32 for x in runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*runs))  # no atomics: bit for bit
    with pytest.raises(ValueError):
        ft.flash_train_fwd(q.detach().half(), k.detach().half(), v.detach().half())


# chip_smoke's _train_cases: the two training cells' layers, c2i without a
# bias, GPT-3B heads (name, B, T, H, D, left-padded caption columns)
_TRAIN_SHAPES = [("t2i_xl512", 8, 1143, 20, 64, 120), ("t2i_b256", 16, 375, 12, 64, 120),
                 ("c2i_b384", 4, 576, 12, 64, 0), ("d100", 2, 333, 32, 100, 120)]


def _fwd_inputs(dev, b, t, h, d, pads, seed, dtype=torch.bfloat16):
    """q, k, v (B, T, H, D), the caption bias of the left pads (None when
    pads is None) and the valid rows."""
    from controlar_tpu_torch.ops import flash_train as ft

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, d, generator=g, device=dev).to(dtype) for _ in range(3))
    valid = torch.ones(b, t, dtype=torch.bool, device=dev)
    if pads is not None:
        valid = torch.arange(t, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
    return q, k, v, (ft.key_bias(valid) if pads is not None else None), valid


def _check_fwd(out, lse, want, valid):
    """out and lse finite everywhere (a fully masked row is finite junk) and
    within the training tolerance of the plain version on the valid rows."""
    out_ref, lse_ref = want
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    rows = valid[:, :, None, None]
    torch.testing.assert_close((out * rows).float(), (out_ref * rows).float(), **_TRAIN_TOL)
    lrows = valid[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[lrows], lse_ref[lrows], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("case", _TRAIN_SHAPES, ids=[c[0] for c in _TRAIN_SHAPES])
def test_flash_train_fwd_matches_plain_version_at_the_training_shapes(dev, case):
    """The forward (the TMA / wgmma variant at D 64, the cp.async one at D
    100) at chip_smoke's four timed shapes, with its caption lengths."""
    from controlar_tpu_torch.cells import train_caption_lens
    from controlar_tpu_torch.ops import flash_train as ft

    name, b, t, h, d, n_cls = case
    pads = [n_cls - n for n in train_caption_lens(b, 7)] if n_cls else None
    q, k, v, kb, valid = _fwd_inputs(dev, b, t, h, d, pads, seed=t)
    out, lse = ft.flash_train_fwd(q, k, v, kb)
    torch.cuda.synchronize()
    _check_fwd(out, lse, ft.flash_train_fwd_ref(q, k, v, kb), valid)


@pytest.mark.parametrize("d", [32, 64, 100, 128])
@pytest.mark.parametrize("t", [1, 40, 64, 65, 130, 333])
def test_flash_train_fwd_matches_plain_version_at_ragged_t(dev, d, t):
    """Every variant (TMA / wgmma at D 64 and 128, cp.async at 32 and 100)
    at T below one 64-row tile, on it, one past it and not a multiple of it,
    with a bias that masks whole rows (3 left pads in batch row 0, T // 2 in
    row 1) and without one."""
    from controlar_tpu_torch.ops import flash_train as ft

    for pads in ([3, t // 2], None):
        q, k, v, kb, valid = _fwd_inputs(dev, 2, t, 3, d, pads, seed=t + d)
        out, lse = ft.flash_train_fwd(q, k, v, kb)
        torch.cuda.synchronize()
        _check_fwd(out, lse, ft.flash_train_fwd_ref(q, k, v, kb), valid)


@pytest.mark.parametrize("d", [64, 100, 128])
def test_flash_train_fwd_is_bitwise_deterministic_and_writes_f32(dev, d):
    """Two launches give the same bits; f32 inputs give an f32 output within
    the tolerance of the plain version."""
    from controlar_tpu_torch.ops import flash_train as ft

    q, k, v, kb, valid = _fwd_inputs(dev, 2, 333, 4, d, [5, 120], seed=d)
    first, second = ft.flash_train_fwd(q, k, v, kb), ft.flash_train_fwd(q, k, v, kb)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    q, k, v, kb, valid = _fwd_inputs(dev, 2, 200, 3, d, [5, 60], seed=d + 1,
                                     dtype=torch.float32)
    out, lse = ft.flash_train_fwd(q, k, v, kb)
    assert out.dtype == torch.float32
    _check_fwd(out, lse, ft.flash_train_fwd_ref(q, k, v, kb), valid)


def _train_bwd_inputs(dev, b, t, h, d, pads, seed):
    """q, k, v, dO (B, T, H, D) bf16, the caption bias of the left pads
    (batch row i's first pads[i] columns masked: those rows see no key) and
    lse, delta from the plain forward; dO is zero on the masked rows."""
    from controlar_tpu_torch.ops import flash_train as ft

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=dev).bfloat16() for _ in range(4))
    valid = torch.arange(t, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
    do = do * valid[:, :, None, None]
    kb = ft.key_bias(valid)
    out, lse = ft.flash_train_fwd_ref(q, k, v, kb)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, kb, do, lse, delta


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("t", [40, 64, 65, 130, 333])
def test_flash_train_backward_matches_plain_version_at_ragged_t(dev, d, t):
    """dq and dk/dv at T below one 64-row tile, on it, one past it and not a
    multiple of it, with a bias that masks whole rows (3 left pads in batch
    row 0, T // 2 in row 1)."""
    from controlar_tpu_torch.ops import flash_train as ft

    args = _train_bwd_inputs(dev, 2, t, 3, d, [3, t // 2], seed=t + d)
    dq = ft.flash_train_dq(*args)
    dk, dv = ft.flash_train_dkv(*args)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), ft.flash_train_bwd_ref(*args)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), **_TRAIN_TOL)


@pytest.mark.parametrize("d", [64, 100])
def test_flash_train_backward_is_bitwise_deterministic(dev, d):
    """Two launches of dq and of dk/dv give the same bits (no atomics, a
    fixed order of sums)."""
    from controlar_tpu_torch.ops import flash_train as ft

    args = _train_bwd_inputs(dev, 2, 333, 4, d, [5, 120], seed=d)
    first = (ft.flash_train_dq(*args), *ft.flash_train_dkv(*args))
    second = (ft.flash_train_dq(*args), *ft.flash_train_dkv(*args))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_control_train_step_card_matches_cpu(dev):
    import copy

    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.ops import flash_train as ft
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import step as tstep
    from controlar_tpu_torch.train.control_step import ControlModel, make_control_train_step

    cfg = GPTConfig(model_type="t2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    caption_dim=32, block_size=16, cls_token_num=8, token_dropout_p=0.0,
                    resid_dropout_p=0.0, ffn_dropout_p=0.0, class_dropout_prob=0.0)
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=6, pos_grid=4)
    model = ControlModel(tgpt.init_gpt(cfg, seed=1), tvit.init_vit(acfg, seed=2))
    with torch.no_grad():  # the t2i head is zero at init
        model.gpt.output.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
    for n, p in model.named_parameters():
        p.requires_grad_(not n.endswith("uncond_embedding"))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 64, (2, 16)), "valid": np.ones(2, np.float32),
             "control_image": rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
             "caption_emb": rng.standard_normal((2, 8, 32)).astype(np.float32),
             "emb_mask": (np.arange(8)[None] >= np.array([[5], [0]])).astype(np.int32)}
    lr, out = 1e-4, {}
    ft.flash_train_fwd.launches = 0
    for device, m in (("cpu", model), ("cuda", copy.deepcopy(model).to(dev))):
        tx = topt.make_optimizer(lr=lr)
        fn = make_control_train_step(cfg, acfg, tx, compute_dtype=torch.float32)
        state, metrics = fn(m, tstep.init_train_state(m, tx),
                            {k: torch.as_tensor(v, device=device) for k, v in batch.items()}, 0)
        out[device] = (metrics["loss"].item(), {n: p.detach().cpu()
                                                for n, p in m.named_parameters()})
    assert ft.flash_train_fwd.launches == 2 * cfg.n_layer  # remat full: the recompute
    # fp32 compute: the loss to 1e-4 relative; one Adam step moves a parameter
    # by at most ~lr, 2 lr where a small gradient's sign flipped
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for n, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][n], p, atol=2 * lr, rtol=0, msg=n)


# ---- the stacked KV cache: stacked decode attention and the stacked append ----

def _stacked_inputs(dev, kind, n_layer, b, s, h, d, bias, split=False, seed=3):
    """q, the in-flight row and its scales (None for bf16), the stack and its
    scales (None for bf16), a left-padded column bias or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h * d, generator=g, device=dev) * 0.5).bfloat16()
    kv = (torch.randn(n_layer, b, s, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    new = (torch.randn(b, 2 * h * d, generator=g, device=dev) * 0.5).bfloat16()
    col_bias = None
    if bias:
        pad = torch.arange(b, device=dev)[:, None] * 7
        col_bias = torch.where(torch.arange(s, device=dev)[None, :] < pad, -1e9, 0.0).float()
    if kind == "bf16":
        return q, new, None, kv, None, col_bias
    quant = quantize_kv_rows if kind == "q8" else (
        lambda x, n: quantize_kv_rows_4(x, n, split=split))
    rows, scale = quant(kv, h)
    new_rows, new_scale = quant(new, h)
    return q, new_rows, new_scale, rows, scale, col_bias


def _stacked_call(kind, fn, q, new, new_s, stack, sc, layer, pos, col_bias, h, d, split):
    if kind == "bf16":
        return fn(q, new, stack, layer, pos, col_bias, n_head=h)
    if kind == "q8":
        return fn(q, new, new_s, stack, sc, layer, pos, col_bias, n_head=h)
    return fn(q, new, new_s, stack, sc, layer, pos, col_bias, n_head=h, head_dim=d, split=split)


@pytest.mark.parametrize("kind", ["bf16", "q8", "q4", "q4_split"])
@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("pos", [0, 1, 255, 256, 575, "per_slot"])
@pytest.mark.parametrize("bias", [False, True])
def test_stacked_kernels_match_plain_versions(dev, kind, d, pos, bias):
    """Every layer of a 3-layer stack, so that a wrong layer offset fails."""
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    split = kind == "q4_split"
    kind = kind[:2] if kind.startswith("q4") else kind
    b, s, h = 4, 768, 3
    if pos == "per_slot":
        pos = torch.tensor([1, 300, 511, 767], dtype=torch.int32, device=dev)
    args = _stacked_inputs(dev, kind, 3, b, s, h, d, bias, split)
    suffix = {"bf16": "", "q8": "_q8", "q4": "_q4"}[kind]
    kern, plain = getattr(fds, f"flash_stacked{suffix}"), getattr(fds, f"flash_stacked{suffix}_ref")
    for layer in range(3):
        out = _stacked_call(kind, kern, *args[:5], layer, pos, args[5], h, d, split)
        torch.cuda.synchronize()
        want = _stacked_call(kind, plain, *args[:5], layer, pos, args[5], h, d, split)
        # bf16 outputs on both sides, as in the flat kernels' tests
        torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)


def test_stacked_kernel_equals_flat_kernel_on_the_written_slab(dev):
    """At a bias of 0 on row pos, the stacked kernel computes the flat
    kernel's function on the layer's slab with the row written."""
    from controlar_tpu_torch.ops.flash_decode_stacked import flash_stacked

    q, new, _, stack, _, bias = _stacked_inputs(dev, "bf16", 2, 4, 768, 3, 64, True)
    pos = torch.tensor([40, 41, 300, 767], dtype=torch.int32, device=dev)
    slab = stack[1].clone()
    slab[torch.arange(4, device=dev), pos.long()] = new
    out = flash_stacked(q, new, stack, 1, pos, bias, n_head=3)
    want = flash_decode_attention(q, slab, pos, bias, n_head=3)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("bad", ["layer", "row_shape", "row_dtype", "scales"])
def test_stacked_wrappers_reject(dev, bad):
    from controlar_tpu_torch.ops.flash_decode_stacked import flash_stacked, flash_stacked_q8

    q, new, new_s, stack, sc, _ = _stacked_inputs(dev, "q8", 2, 2, 256, 2, 64, False)
    layer = 2 if bad == "layer" else 0
    if bad == "row_shape":
        new = new[:, :-16].contiguous()
    elif bad == "scales":
        new_s = new_s[:, :-1].contiguous()
    with pytest.raises(ValueError):
        if bad == "row_dtype":
            qb, nb, _, sb, _, _ = _stacked_inputs(dev, "bf16", 2, 2, 256, 2, 64, False)
            flash_stacked(qb, nb.float(), sb, 0, 10, n_head=2)
        else:
            flash_stacked_q8(q, new, new_s, stack, sc, layer, 10, n_head=2)


def test_stacked_launch_counts(dev):
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    fns = (fds.flash_stacked, fds.flash_stacked_q8, fds.flash_stacked_q4)
    for fn in fns:
        fn.launches = 0
    for kind, fn in zip(("bf16", "q8", "q4"), fns):
        args = _stacked_inputs(dev, kind, 2, 2, 256, 2, 64, False)
        for _ in range(2):
            _stacked_call(kind, fn, *args[:5], 1, 10, None, 2, 64, False)
    assert [fn.launches for fn in fns] == [2, 2, 2]


@pytest.mark.parametrize("dtype,width", APPEND_STREAMS)
def test_cache_append_stacked_matches_plain_version(dev, dtype, width):
    from controlar_tpu_torch.ops.cache_append import (
        cache_append_rows_stacked, cache_append_rows_stacked_ref)

    n_layer, b, s = 12, 16, 768
    g = torch.Generator(device=dev).manual_seed(width + 1)
    if dtype == torch.int8:
        cache = torch.randint(-128, 128, (n_layer, b, s, width), generator=g, device=dev,
                              dtype=dtype)
        rows = torch.randint(-128, 128, (n_layer, b, width), generator=g, device=dev,
                             dtype=dtype)
    else:
        cache = torch.randn(n_layer, b, s, width, generator=g, device=dev).to(dtype)
        rows = torch.randn(n_layer, b, width, generator=g, device=dev)  # cast by the wrapper
    pos = torch.tensor([0, s - 1] + [7 * i + 3 for i in range(b - 2)], dtype=torch.int32,
                       device=dev)
    want = cache_append_rows_stacked_ref(cache.clone(), rows, pos)
    before = cache_append_rows_stacked.launches
    out = cache_append_rows_stacked(cache, rows, pos)
    torch.cuda.synchronize()
    assert out is cache and cache_append_rows_stacked.launches == before + 1
    assert torch.equal(cache.view(torch.uint8), want.view(torch.uint8))


def test_cache_append_stacked_skips_out_of_range_slots(dev):
    from controlar_tpu_torch.ops.cache_append import cache_append_rows_stacked

    cache = torch.zeros(2, 3, 8, 16, dtype=torch.bfloat16, device=dev)
    rows = torch.ones(2, 3, 16, device=dev)
    cache_append_rows_stacked(cache, rows, torch.tensor([-1, 8, 2], dtype=torch.int32,
                                                        device=dev))
    torch.cuda.synchronize()
    assert cache[:, :2].abs().sum().item() == 0 and cache[:, 2, 2].float().sum().item() == 32


# the stacked cells' steps: layers, kv heads, head dim, int4 split, cache rows
_STACKED_WRITE = {"gpt_b": (12, 12, 64, False, 768), "gpt_3b": (24, 32, 100, True, 768)}


def _stacked_write_case(dev, shape, kind, seed, b=16):
    """A stacked cache of kind (bf16, int8, int4, int4_pairs) with random
    contents and one step's k, v (b, 1, KV*D) bf16 views per layer."""
    n_layer, kvh, d, split, s = _STACKED_WRITE[shape]
    kvd = kvh * d
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "bf16":
        cache = torch.randn(n_layer, b, s, 2 * kvd, generator=g, device=dev).bfloat16()
    else:
        key, width = ("kv", 2 * kvd) if kind == "int8" else ("kv4", kvd)
        cache = {key: torch.randint(-128, 128, (n_layer, b, s, width), generator=g, device=dev,
                                    dtype=torch.int8),
                 "s": torch.rand(n_layer, b, s, 2 * kvh, generator=g, device=dev) * 0.02}
    new = []
    for _ in range(n_layer):
        qkv = (torch.randn(b, 1, 3 * kvd, generator=g, device=dev) * 2).bfloat16()
        new.append((qkv[..., kvd:2 * kvd], qkv[..., 2 * kvd:]))
    new[0][0][0, 0, :d] = 0
    return cache, new, kvh, split and kind == "int4"


def _stacked_step_writes(cache, new, pos, kvh, split, old=False):
    """The stacked step's writes: append_kv into the in-flight rows a layer
    and one append_stacked, or (old) the sequence they replace."""
    from controlar_tpu_torch.ops import cache_append as ca

    if not old:
        inflight = ca.stacked_inflight(cache, new[0][0].shape[0])
        for l, (k, v) in enumerate(new):
            ca.append_kv(ca.inflight_layer(inflight, l), k, v, 0, kv_heads=kvh, split=split)
        return ca.append_stacked(cache, inflight, pos), inflight
    rows = [[src.to(dst.dtype).contiguous() for dst, src in ca.cache_streams(
        cache, torch.cat([k[:, 0], v[:, 0]], dim=-1), kvh, split)] for k, v in new]
    for i, dst in enumerate(ca.stream_list(cache)):
        stacked = torch.stack([r[i] for r in rows])
        if isinstance(pos, int):
            dst[:, :, pos] = stacked
        else:
            ca.cache_append_rows_stacked(dst, stacked, pos)
    return cache, None


@pytest.mark.parametrize("pos", ["int", "per_slot"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int4_pairs"])
@pytest.mark.parametrize("shape", list(_STACKED_WRITE))
def test_append_stacked_matches_plain_version_and_old_sequence(dev, shape, kind, pos):
    """The fused stacked writes (one append_kv a layer, one append_stacked a
    step) leave the cache bit for bit as the old sequence and as the plain
    end-of-step write on the same in-flight rows, with one launch a step."""
    from controlar_tpu_torch.ops import cache_append as ca

    cache, new, kvh, split = _stacked_write_case(dev, shape, kind, seed=len(shape + kind))
    s = ca.stream_list(cache)[0].shape[2]
    p = s - 1 if pos == "int" else torch.tensor(
        [1, s - 1] + [(37 * i) % s for i in range(1, 15)], dtype=torch.int32, device=dev)
    clone = lambda c: {k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone()  # noqa: E731
    before = ca.append_stacked.launches
    got, inflight = _stacked_step_writes(clone(cache), new, p, kvh, split)
    assert ca.append_stacked.launches == before + 1
    old, _ = _stacked_step_writes(clone(cache), new, p, kvh, split, old=True)
    plain = ca.append_stacked_ref(clone(cache), inflight, p)
    torch.cuda.synchronize()
    for a, b, c in zip(ca.stream_list(got), ca.stream_list(old), ca.stream_list(plain)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))


def test_append_stacked_skips_out_of_range_slots(dev):
    from controlar_tpu_torch.ops import cache_append as ca

    cache = {"kv": torch.zeros(2, 3, 8, 16, dtype=torch.int8, device=dev),
             "s": torch.zeros(2, 3, 8, 4, device=dev)}
    inflight = ca.stacked_inflight(cache, 3)
    for x in inflight.values():
        x.fill_(1)
    ca.append_stacked(cache, inflight, torch.tensor([-1, 8, 2], dtype=torch.int32, device=dev))
    ca.append_stacked(cache, inflight, 8)  # an int position past the cache: nothing written
    torch.cuda.synchronize()
    for x in cache.values():
        assert x[:, :2].abs().sum().item() == 0
        assert x[:, 2, 2].float().sum().item() == x.shape[0] * x.shape[-1]
        assert x.float().sum().item() == x.shape[0] * x.shape[-1]


def _small_model(dev, dtype=torch.float32, quant=None):
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.quant import quantize_gpt

    cfg = GPTConfig(model_type="c2i", dim=256, n_layer=3, n_head=4, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=dtype)
    if quant is not None:
        quantize_gpt(model, cfg, mode=quant, split_rope=quant == "w4")
    return cfg, model


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_generate_stacked_card_matches_cpu(dev, cache):
    """Greedy generate(kv_stacked=True) through the stacked kernels on the
    card: the first logits within the reference limits, tokens equal to the
    CPU's plain route at a clear margin, and the exact kernel launches (a
    fused KV write a layer into the in-flight rows, one end-of-step write
    a step)."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.ops import cache_append as ca
    from controlar_tpu_torch.ops import flash_decode_stacked as fds

    quant, cache_dtype = {"bf16": (None, torch.bfloat16), "int8": ("int8", torch.int8),
                          "int4": ("w4", "int4")}[cache]
    cfg, model = _small_model("cpu", quant=quant)
    kw = dict(labels=torch.arange(3), max_new_tokens=16, cfg_scale=2.0, sample_logits=False,
              cache_dtype=cache_dtype, kv_stacked=True)
    want = tgen.generate(model, cfg, device="cpu", **kw)
    fn = {"bf16": fds.flash_stacked, "int8": fds.flash_stacked_q8,
          "int4": fds.flash_stacked_q4}[cache]
    fn.launches = ca.cache_append_rows.launches = flash_decode_attention.launches = 0
    ca.append_kv.launches = ca.append_stacked.launches = ca.cache_append_rows_stacked.launches = 0
    got = tgen.generate(model.to(dev), cfg, device=dev, **kw).cpu()
    steps = cfg.block_size - 1
    assert fn.launches == ca.append_kv.launches == cfg.n_layer * steps
    assert ca.append_stacked.launches == steps  # one end-of-step write a step
    assert ca.cache_append_rows.launches == flash_decode_attention.launches == 0
    assert ca.cache_append_rows_stacked.launches == 0
    # greedy tokens at random weights: ties flip rarely; require most to agree
    assert (got == want).float().mean().item() >= 0.85, (got, want)


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8])
def test_serve_stacked_slot_isolation_on_the_card(dev, cache):
    """The stacked engine on the card: request 0 alone (slot 1 never
    admitted, so the pos >= 1 clamp runs every step) and with a neighbour:
    the same sampled tokens; one fused KV write a layer and one end-of-step
    write a step."""
    from controlar_tpu_torch.cells import serve_requests, serve_staggered
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.ops import cache_append as ca
    from controlar_tpu_torch.serve import ServeConfig, ServeEngine

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device=dev)

    def run(n):
        eng = ServeEngine(model, cfg, ServeConfig(max_slots=2, quantum=6, top_k=8,
                                                  cache_dtype=cache, kv_stacked=True),
                          device=dev)
        done = serve_staggered(eng, serve_requests(n, num_classes=10), upfront=1,
                               add_after_step=1)
        return done, eng.stats["slot_steps"] // 2

    ca.cache_append_rows.launches = ca.cache_append_rows_stacked.launches = 0
    ca.append_kv.launches = ca.append_stacked.launches = 0
    (solo, steps), (duo, steps2) = run(1), run(2)
    assert ca.append_stacked.launches == steps + steps2
    assert ca.append_kv.launches == cfg.n_layer * (steps + steps2)
    assert ca.cache_append_rows.launches == ca.cache_append_rows_stacked.launches == 0
    np.testing.assert_array_equal(solo[0].tokens, duo[0].tokens)
    assert not np.array_equal(duo[0].tokens, duo[1].tokens)


# ---------------------------------------------------------------------------
# The condition networks (no kernel of their own: library convolutions and
# matmuls, fp32) on the card against the same modules on the CPU, TF32 off.
# ---------------------------------------------------------------------------

# relative to the output's largest magnitude: fp32 card vs CPU reads at
# most 4.3e-6 on an H100, TF32 on at least 2.7e-4 (chip_smoke.py
# condition_reference)
COND_TOL = 1e-4


@pytest.fixture
def fp32_exact(dev):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


_SMALL_DPT = dict(hidden_size=64, n_layer=4, n_head=2, mlp_dim=128, pos_grid=4,
                  out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 32, 64, 64),
                  fusion_hidden_size=32)
_SMALL_MIDAS = dict(stem_width=32, layers=(1, 1, 1), hidden_size=64, n_layer=3, n_head=2,
                    mlp_dim=128, pos_grid=4, vit_hooks=(1, 2), features=32,
                    layer_channels=(256, 512, 64, 64))


def _small_condition(name):
    """(small module on the CPU, f(module, uint8 images) -> 0..255 map)."""
    from controlar_tpu_torch.models import control_nets as cn
    from controlar_tpu_torch.models import dpt as tdpt
    from controlar_tpu_torch.models import midas as tmidas
    from controlar_tpu_torch.models.control_nets import condition_map

    if name == "hed":
        return (cn.init_hed(seed=1, device="cpu", channels=(8, 16, 32, 32, 32)),
                lambda m, x: condition_map("hed", x, hed=m))
    if name == "lineart":
        return (cn.init_lineart(seed=2, device="cpu", ngf=8),
                lambda m, x: condition_map("lineart", x, lineart=m))
    if name == "dpt":
        cfg = tdpt.DPTConfig(**_SMALL_DPT)
        return (tdpt.init_dpt(cfg, seed=3, device="cpu"),
                lambda m, x: condition_map("depth", x, dpt=m, dpt_cfg=cfg))
    cfg = tmidas.MidasHybridConfig(**_SMALL_MIDAS)
    return (tmidas.init_midas(cfg, seed=4, device="cpu"),
            lambda m, x: condition_map("depth", x, midas=m, midas_cfg=cfg))


@pytest.mark.parametrize("name", ["hed", "lineart", "dpt", "midas"])
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_condition_network_card_matches_cpu(fp32_exact, name, hw):
    from controlar_tpu_torch.cells import condition_images

    img = torch.from_numpy(condition_images(2, 96, seed=9)[:, :hw[0], :hw[1]].copy())
    model, fn = _small_condition(name)
    with torch.inference_mode():
        want = fn(model, img)
        got = fn(copy.deepcopy(model).to(fp32_exact), img.to(fp32_exact)).cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= COND_TOL * want.abs().max().item()


def test_hed_nms_card_matches_cpu(dev):
    from controlar_tpu_torch.models.control_nets import hed_nms

    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 48, 64)).astype(np.float32))
    for s, t in ((2.0, 64.0), (1.0, 100.0)):
        torch.testing.assert_close(hed_nms(x.to(dev), t, s).cpu(), hed_nms(x, t, s),
                                   rtol=0, atol=0)


def test_c2i_depth_pipeline_on_the_card(fp32_exact):
    """The c2i_depth cell's path at a small size: the MiDaS condition card
    against CPU, then generate on the card through the decode kernels."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.config import GPTConfig, VQConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.models import midas as tmidas
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.ops import flash_decode as fd
    from controlar_tpu_torch.pipeline import ControlARPipeline

    img = 64
    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, block_size=(img // 16) ** 2)
    vcfg = VQConfig(codebook_size=64, z_channels=32, ch=32, decoder_ch_mult=(1, 1, 1, 1, 2))
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=6, pos_grid=4)
    midas, _ = _small_condition("midas")

    def pipe(device):
        return ControlARPipeline(
            gpt_cfg=cfg, gpt=tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device=device),
            vq_cfg=vcfg, vq=tvq.init_vq(vcfg, seed=1, device=device), adapter_cfg=acfg,
            adapter=tvit.init_vit(acfg, seed=2, device=device), condition_type="depth",
            midas=copy.deepcopy(midas).to(device),
            midas_cfg=tmidas.MidasHybridConfig(**_SMALL_MIDAS), device=device)

    images = condition_images(2, img, seed=5)
    cond_cpu = pipe("cpu").extract_condition(images)
    card = pipe(fp32_exact)
    cond = card.extract_condition(images).cpu()
    assert (cond - cond_cpu).abs().max().item() <= 2 * COND_TOL
    fd.flash_decode_attention.launches = 0
    timings = {}
    out = card.generate(labels=np.array([1, 2]), condition_images=images, top_k=4,
                        timings=timings)
    assert out.shape == (2, img, img, 3) and out.dtype == np.uint8
    assert fd.flash_decode_attention.launches == cfg.n_layer * (cfg.block_size - 1)
    assert list(timings) == ["condition", "adapter", "tokens", "vq_decode"]


# ---------------------------------------------------------------------------
# Slice 8: checkpoint loading, the VQ encoder, the quant report on the card
# ---------------------------------------------------------------------------

def test_safetensors_bf16_loads_onto_the_card_bit_for_bit(dev, tmp_path):
    """A bf16 .safetensors in the reference GPT layout -> load_gpt_checkpoint
    on the card in bf16: every parameter its source's bits."""
    from controlar_tpu_torch import checkpoint, convert_ref
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt

    cfg = GPTConfig(model_type="t2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    caption_dim=32, cls_token_num=5, block_size=16)
    src = tgpt.init_gpt(cfg, seed=5)
    sd = {k: v.bfloat16() for k, v in convert_ref.gpt_reference_state_dict(src).items()}
    path = str(tmp_path / "gpt_bf16.safetensors")
    checkpoint.save_safetensors(sd, path)
    raw = checkpoint.load_safetensors(path)
    assert all(torch.equal(raw[k], v) for k, v in sd.items())
    got = checkpoint.load_gpt_checkpoint(path, cfg, torch.bfloat16, dev)
    want = src.to(torch.bfloat16).state_dict()
    for k, v in got.state_dict().items():
        assert v.device.type == "cuda" and v.dtype == torch.bfloat16
        assert torch.equal(v.cpu(), want[k]), k


def test_trainer_on_the_card_keeps_its_control_modules_on_a_base_checkpoint(dev, tmp_path):
    """TrainerConfig.gpt_ckpt of a base checkpoint on the card: the file's
    parameters, and the control modules of the trainer's own fresh GPT
    (drawn on the card), not a CPU draw."""
    from controlar_tpu_torch import checkpoint, convert_ref
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    kw = dict(gpt_model="GPT-B", image_size=64, cls_token_num=8, global_batch_size=2,
              seed=3, model_overrides=dict(dim=64, n_layer=3, n_head=4, vocab_size=64,
                                           caption_dim=32),
              adapter_override=tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2,
                                              pos_grid=4))
    fresh = Trainer(TrainerConfig(results_dir=str(tmp_path / "a"), **kw), device=dev)
    fresh.init_state()
    weights = tgpt.init_gpt(fresh.gpt_cfg, seed=9)
    path = str(tmp_path / "base.safetensors")
    checkpoint.save_safetensors({k: v for k, v in
                                 convert_ref.gpt_reference_state_dict(weights).items()
                                 if not k.startswith(convert_ref.CONTROL_MODULES)}, path)
    loaded = Trainer(TrainerConfig(results_dir=str(tmp_path / "b"), gpt_ckpt=path, **kw),
                     device=dev)
    loaded.init_state()
    for n, p in loaded.model.gpt.named_parameters():
        assert p.device.type == "cuda", n
        want = fresh.model.gpt if n.startswith(convert_ref.CONTROL_MODULES) else weights
        assert torch.equal(p.cpu(), want.state_dict()[n].cpu()), n


def test_vq_encode_card_matches_cpu(fp32_exact):
    """encode then decode_code of a small VQ, card against CPU, fp32: codes
    equal or ties (their distances within 1e-5), images within 1e-4."""
    from controlar_tpu_torch.config import VQConfig
    from controlar_tpu_torch.models import vq as tvq

    cfg = VQConfig(codebook_size=256, codebook_embed_dim=8, z_channels=32, ch=32,
                   encoder_ch_mult=(1, 1, 2, 4), decoder_ch_mult=(1, 1, 2, 4))
    vq_cpu = tvq.init_vq(cfg, seed=6)
    vq_card = copy.deepcopy(vq_cpu).to(fp32_exact)
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.inference_mode():
        zq_card, idx_card = tvq.encode(vq_card, cfg, x.to(fp32_exact), device=fp32_exact)
        zq_cpu, idx_cpu = tvq.encode(vq_cpu, cfg, x, device="cpu")
        h = tvq._conv(vq_cpu.quant_conv, tvq.encoder_forward(vq_cpu.encoder, cfg, x))
        differ = idx_card.cpu() != idx_cpu
        if differ.any():
            zn = torch.nn.functional.normalize(h[differ], dim=-1)
            emb = tvq._codebook(vq_cpu, cfg)
            d = (zn * zn).sum(-1, keepdim=True) + (emb * emb).sum(-1) - 2 * zn @ emb.T
            rows = torch.arange(len(zn))
            gap = (d[rows, idx_card.cpu()[differ]] - d[rows, idx_cpu[differ]]).abs()
            assert gap.max().item() <= 1e-5
        assert (zq_card.cpu()[~differ] - zq_cpu[~differ]).abs().max().item() <= 1e-5
        img_card = tvq.decode_code(vq_card, cfg, idx_cpu.to(fp32_exact)).cpu()
        img_cpu = tvq.decode_code(vq_cpu, cfg, idx_cpu)
    assert img_card.shape == (2, 64, 96, 3)
    assert (img_card - img_cpu).abs().max().item() <= 1e-4


def test_quant_report_on_the_card(dev):
    """measure_quant_agreement of a small bf16 c2i model on the card: every
    metric of every mode in range; the W4 modes launch the W4 kernels."""
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.eval.quant_report import MODES, measure_quant_agreement
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.ops import w4_matmul as w4

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, cls_token_num=1,
                    block_size=64, vocab_size=512, num_classes=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    w4.w4_matmul.launches = 0
    rep = measure_quant_agreement(model, cfg, modes=MODES, max_new_tokens=64, device=dev)
    assert set(rep) == set(MODES) and w4.w4_matmul.launches > 0
    for m in rep.values():
        assert 0 <= m["teacher_forced_agreement"] <= 1 and 0 <= m["sampled_agreement"] <= 1
        assert 0 <= m["mean_prefix_survival"] <= 64 and np.isfinite(m["max_rel_logit_err"])
    assert rep["int8"]["max_rel_logit_err"] <= rep["w4"]["max_rel_logit_err"]
