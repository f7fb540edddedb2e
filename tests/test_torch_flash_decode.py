"""The port's flash-decode plain version against the JAX package's Pallas
kernel (interpret mode) and its masked-einsum attention (CPU).

Tolerances: the Pallas kernel rounds p and alpha to bf16 before its value
products, which the port keeps in fp32, so the two agree to 2e-2 (the JAX
package's own kernel tolerance). Against the fp32 masked einsum, with q
already bf16-valued, they agree to 1e-5.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu.config import GPTConfig
from controlar_tpu.models.gpt import _attend_full
from controlar_tpu.ops.flash_decode2 import flash_decode_attention2
from controlar_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_ref,
)


def _inputs(seed, b, s, h, d, pos_kind, with_bias):
    rng = np.random.default_rng(seed)
    hd = h * d
    kv = np.asarray(jnp.asarray(rng.standard_normal((b, s, 2 * hd)) * 0.5, jnp.bfloat16),
                    np.float32)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, hd)) * 0.5, jnp.bfloat16), np.float32)
    if pos_kind == "zero":
        pos = np.asarray(0, np.int32)
    elif pos_kind == "scalar":
        pos = np.asarray(s - 57, np.int32)
    else:
        pos = rng.integers(0, s, b).astype(np.int32)
        pos[0] = s - 1
    bias = None
    if with_bias:
        pad = rng.integers(0, 40, b)  # left-padded prefixes
        bias = np.where(np.arange(s)[None, :] < pad[:, None], -1e9, 0.0).astype(np.float32)
        bias[:, 0] = 0.0  # keep row 0 visible so pos = 0 stays defined
    return q, kv, pos, bias


def _port(q, kv, pos, bias, h):
    return flash_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kv).bfloat16(), torch.from_numpy(pos),
        None if bias is None else torch.from_numpy(bias), n_head=h).numpy()


CASES = [(d, pos_kind, with_bias)
         for d in (64, 128)
         for pos_kind in ("zero", "scalar", "per_slot")
         for with_bias in (False, True)]


@pytest.mark.parametrize("d,pos_kind,with_bias", CASES)
def test_ref_matches_pallas_kernel(d, pos_kind, with_bias):
    b, s, h = 3, 256, 2
    q, kv, pos, bias = _inputs(d + len(pos_kind), b, s, h, d, pos_kind, with_bias)
    want = flash_decode_attention2(
        jnp.asarray(q), jnp.asarray(kv, jnp.bfloat16), jnp.asarray(pos),
        None if bias is None else jnp.asarray(bias), n_head=h, block=128, interpret=True)
    got = _port(q, kv, pos, bias, h)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("d,pos_kind,with_bias", CASES)
def test_ref_matches_masked_einsum(d, pos_kind, with_bias):
    b, s, h = 3, 96, 2
    q, kv, pos, bias = _inputs(7 * d + len(pos_kind), b, s, h, d, pos_kind, with_bias)
    hd = h * d
    cfg = GPTConfig(dim=hd, n_head=h, n_layer=1)
    allowed = np.arange(s)[None, :] <= np.broadcast_to(pos, (b,))[:, None]
    if bias is not None:
        allowed &= bias == 0
    want = _attend_full(
        cfg, jnp.asarray(q).reshape(b, 1, h, d),
        jnp.asarray(kv[..., :hd]).reshape(b, s, h, d),
        jnp.asarray(kv[..., hd:]).reshape(b, s, h, d),
        jnp.asarray(allowed)[:, None, None, :])
    got = _port(q, kv, pos, bias, h)
    np.testing.assert_allclose(got, np.asarray(want).reshape(b, hd), atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    q, kv, pos, bias = _inputs(1, 2, 64, 2, 64, "per_slot", True)
    args = (torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16(),
            torch.from_numpy(pos), torch.from_numpy(bias))
    before = flash_decode_attention.launches
    out = flash_decode_attention(*args, n_head=2)
    assert flash_decode_attention.launches == before  # no kernel launch on the CPU
    assert out.dtype == torch.bfloat16 and out.shape == (2, 128)
    torch.testing.assert_close(out, flash_decode_attention_ref(*args, n_head=2), rtol=0, atol=0)
