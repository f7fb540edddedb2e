"""The fused int8 decode attention with row append against the JAX package's
Pallas kernel (`flash_decode_attention2_q8_append`) in interpret mode (CPU).

The port's plain version writes the row, then attends over rows [0, pos]
with fp32 probabilities; the Pallas kernel scores the in-flight row from
operands and rounds p * vs, alpha and the new row's products to bf16.
Outputs of |o| < 1 agree to 1e-2 (the JAX package's own test allows 3e-2
between its kernel and its separate ops). The written int8 rows and scales
are copies and must match bit for bit; the JAX scale slab is padded to 128
lanes, of which the first 2H are compared.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.ops import flash_decode2 as jfd
from controlar_tpu_torch.ops import flash_decode as tfd


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((b, s, 2 * h * d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((b, h * d)) * 0.5).astype(np.float32)
    row = rng.standard_normal((b, 2 * h * d)).astype(np.float32)
    return q, kv, row


def _pos(kind, b, s):
    if kind == "first":
        return np.asarray(1, np.int32)
    if kind == "last":
        return np.asarray(s - 1, np.int32)
    return np.asarray([1, s - 1, 37][:b], np.int32)


CASES = [(d, pos_kind, with_bias)
         for d in (64, 100)
         for pos_kind in ("first", "last", "per_slot")
         for with_bias in (False, True)]


@pytest.mark.parametrize("d,pos_kind,with_bias", CASES)
def test_q8_append_plain_version_matches_pallas_kernel(d, pos_kind, with_bias):
    b, s, h = 3, 128, 2
    q, kv, row = _inputs(d + len(pos_kind) + with_bias, b, s, h, d)
    pos = _pos(pos_kind, b, s)
    rows, scale = jquant.quantize_kv_rows(jnp.asarray(kv), h)
    new_kv, new_s = jquant.quantize_kv_rows(jnp.asarray(row), h)
    bias = None
    if with_bias:  # left-padded prefixes, each shorter than its row's pos
        pad = np.minimum([0, 1, 30], np.broadcast_to(pos, (b,)))
        bias = np.where(np.arange(s)[None, :] < pad[:, None], -1e9, 0.0).astype(np.float32)
    want, kv_want, s_want = jfd.flash_decode_attention2_q8_append(
        jnp.asarray(q), new_kv, jdec._pad_scales(new_s, h), rows, jdec._pad_scales(scale, h),
        jnp.asarray(pos), None if bias is None else jnp.asarray(bias), n_head=h, block=64,
        interpret=True)

    kv_t, s_t = _t(rows).clone(), _t(scale).clone()
    got, kv_got, s_got = tfd.flash_decode_attention_q8_append(
        _t(q), _t(new_kv), _t(new_s), kv_t, s_t, _t(pos) if pos.ndim else int(pos),
        None if bias is None else _t(bias), n_head=h)
    assert kv_got is kv_t and s_got is s_t  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    np.testing.assert_array_equal(kv_got.numpy(), np.asarray(kv_want))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want)[..., :2 * h])


def test_q8_append_wrapper_on_the_cpu_is_the_plain_version():
    """The CPU route of the wrapper equals writing the row and running the
    int8 plain version over rows [0, pos]; rows past pos stay as they were."""
    b, s, h, d = 2, 64, 2, 64
    q, kv, row = _inputs(5, b, s, h, d)
    rows, scale = (_t(a) for a in jquant.quantize_kv_rows(jnp.asarray(kv), h))
    new_kv, new_s = (_t(a) for a in jquant.quantize_kv_rows(jnp.asarray(row), h))
    pos = torch.tensor([3, 40], dtype=torch.int32)
    kv_w, s_w = rows.clone(), scale.clone()
    kv_w[torch.arange(b), pos.long()] = new_kv
    s_w[torch.arange(b), pos.long()] = new_s
    want = tfd.flash_decode_attention_q8_ref(_t(q), kv_w, s_w, pos, n_head=h)
    got, kv_got, s_got = tfd.flash_decode_attention_q8_append(
        _t(q), new_kv, new_s, rows.clone(), scale.clone(), pos, n_head=h)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert torch.equal(kv_got, kv_w) and torch.equal(s_got, s_w)


@pytest.mark.parametrize("pos", [0, -1, 64])
def test_q8_append_rejects_a_position_outside_the_decode_range(pos):
    b, s, h, d = 2, 64, 2, 64
    q, kv, row = _inputs(6, b, s, h, d)
    rows, scale = (_t(a) for a in jquant.quantize_kv_rows(jnp.asarray(kv), h))
    new_kv, new_s = (_t(a) for a in jquant.quantize_kv_rows(jnp.asarray(row), h))
    with pytest.raises(ValueError):
        tfd.flash_decode_attention_q8_append(_t(q), new_kv, new_s, rows, scale, pos, n_head=h)
