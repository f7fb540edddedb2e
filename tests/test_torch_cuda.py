"""Kernel tests that need an NVIDIA card; they skip without one.

Run on the card without the JAX test configuration:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from controlar_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_ref,
)

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
