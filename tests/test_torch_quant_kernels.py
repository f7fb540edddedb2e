"""The plain versions of the quantized kernels against the JAX package's
Pallas kernels in interpret mode (CPU).

Tolerances:
- q8 / q4 decode attention: the Pallas kernels round p * vs and alpha to
  bf16 before the value products, which the port keeps in fp32; outputs of
  |o| < 1 agree to 1e-2 (the JAX package's own q8 test allows 2e-2);
- w4_matmul: both take bf16 x and fp32 per-plane sums times the plane scale;
  only the order of fp32 sums differs: 1e-5 relative;
- w4_ffn: as w4_matmul, and an fp32 difference may flip a bf16 rounding of
  the gate output z, which moves an output by ~1e-4 here: 1e-3.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import quant as jquant
from controlar_tpu.ops import flash_decode2 as jfd
from controlar_tpu.ops import w4_matmul as jw4
from controlar_tpu_torch import quant as tquant
from controlar_tpu_torch.ops import flash_decode as tfd
from controlar_tpu_torch.ops import w4_matmul as tw4


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_inputs(seed, b, s, h, d, pos_kind, with_bias):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((b, s, 2 * h * d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((b, h * d)) * 0.5).astype(np.float32)
    if pos_kind == "zero":
        pos = np.asarray(0, np.int32)
    elif pos_kind == "scalar":
        pos = np.asarray(s - 37, np.int32)
    else:
        pos = rng.integers(0, s, b).astype(np.int32)
        pos[0] = s - 1
    bias = None
    if with_bias:
        pad = rng.integers(0, 30, b)  # left-padded prefixes
        bias = np.where(np.arange(s)[None, :] < pad[:, None], -1e9, 0.0).astype(np.float32)
        bias[:, 0] = 0.0  # keep row 0 visible so pos = 0 stays defined
    return q, kv, pos, bias


ATTN_CASES = [(d, pos_kind, with_bias)
              for d in (64, 100)
              for pos_kind in ("zero", "scalar", "per_slot")
              for with_bias in (False, True)]


@pytest.mark.parametrize("d,pos_kind,with_bias", ATTN_CASES)
def test_q8_plain_version_matches_pallas_kernel(d, pos_kind, with_bias):
    b, s, h = 3, 128, 2
    q, kv, pos, bias = _attn_inputs(d + len(pos_kind), b, s, h, d, pos_kind, with_bias)
    rows, scale = jquant.quantize_kv_rows(jnp.asarray(kv), h)
    jbias = None if bias is None else jnp.asarray(bias)
    want = jfd.flash_decode_attention2_q8(jnp.asarray(q), rows, scale, jnp.asarray(pos), jbias,
                                          n_head=h, block=64, interpret=True)
    got = tfd.flash_decode_attention_q8_ref(_t(q), _t(rows), _t(scale), _t(pos),
                                            None if bias is None else _t(bias), n_head=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("d,pos_kind,with_bias",
                         [c for c in ATTN_CASES if c[1] != "zero"])
def test_q4_plain_version_matches_pallas_kernel(split, d, pos_kind, with_bias):
    """The JAX slab pads each half of a row to 128 bytes; the port's does not."""
    b, s, h = 3, 128, 2
    q, kv, pos, bias = _attn_inputs(2 * d + len(pos_kind), b, s, h, d, pos_kind, with_bias)
    carriers, scale = jquant.quantize_kv_rows_4(jnp.asarray(kv), h, split=split)
    jbias = None if bias is None else jnp.asarray(bias)
    want = jfd.flash_decode_attention2_q4(jnp.asarray(q), carriers, scale, jnp.asarray(pos),
                                          jbias, n_head=h, head_dim=d, block=64,
                                          interpret=True, split=split)
    half = h * d // 2
    rows = np.asarray(carriers).reshape(b, s, 2, -1)[..., :half].reshape(b, s, -1)
    got = tfd.flash_decode_attention_q4_ref(_t(q), _t(rows), _t(scale), _t(pos),
                                            None if bias is None else _t(bias), n_head=h,
                                            head_dim=d, split=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


def _w4(rng, k, n):
    return jw4.quantize_weight_w4(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)
                                              * 0.05))


# K: 256 two planes; 3200 25 planes (odd tail, x unpadded); 200 padded x
@pytest.mark.parametrize("rows", [1, 16, 17])
@pytest.mark.parametrize("k", [256, 3200, 200])
def test_w4_matmul_plain_version_matches_pallas_kernel(rows, k):
    rng = np.random.default_rng(rows + k)
    w = _w4(rng, k, 256)
    x = jnp.asarray(rng.standard_normal((rows, k)).astype(np.float32) * 0.5, jnp.bfloat16)
    want = jw4.w4_matmul(x, w["q4"], w["s"], out_dtype=jnp.float32, interpret=True)
    got = tw4.w4_matmul_ref(_t(np.asarray(x, np.float32)).bfloat16(), _t(w["q4"]), _t(w["s"]),
                            torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# K = 384 and F = 640: odd plane counts (3 and 5) in both products
@pytest.mark.parametrize("rows", [1, 16])
def test_w4_ffn_plain_version_matches_pallas_kernel(rows):
    rng = np.random.default_rng(rows)
    k, f, n = 384, 640, 256
    w13, w2 = _w4(rng, k, 2 * f), _w4(rng, f, n)
    x = jnp.asarray(rng.standard_normal((rows, k)).astype(np.float32) * 0.5, jnp.bfloat16)
    want = jw4.w4_ffn(x, w13["q4"], w13["s"], w2["q4"], w2["s"], out_dtype=jnp.float32,
                      interpret=True)
    got = tw4.w4_ffn_ref(_t(np.asarray(x, np.float32)).bfloat16(), _t(w13["q4"]), _t(w13["s"]),
                         _t(w2["q4"]), _t(w2["s"]), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    rng = np.random.default_rng(0)
    w13 = tw4.quantize_weight_w4(_t(rng.standard_normal((256, 512)).astype(np.float32)))
    w2 = tw4.quantize_weight_w4(_t(rng.standard_normal((256, 128)).astype(np.float32)))
    x = _t(rng.standard_normal((4, 256)).astype(np.float32)).bfloat16()
    q, kv, pos, _ = _attn_inputs(1, 2, 64, 2, 64, "per_slot", False)
    rows8, s8 = jquant.quantize_kv_rows(jnp.asarray(kv), 2)
    rows4, s4 = tquant.quantize_kv_rows_4(_t(kv), 2)
    before = (tw4.w4_matmul.launches, tw4.w4_ffn.launches,
              tfd.flash_decode_attention_q8.launches, tfd.flash_decode_attention_q4.launches)
    pairs = [
        (tw4.w4_matmul(x, *w13), tw4.w4_matmul_ref(x, *w13)),
        (tw4.w4_ffn(x, *w13, *w2), tw4.w4_ffn_ref(x, *w13, *w2)),
        (tfd.flash_decode_attention_q8(_t(q), _t(rows8), _t(s8), _t(pos), n_head=2),
         tfd.flash_decode_attention_q8_ref(_t(q), _t(rows8), _t(s8), _t(pos), n_head=2)),
        (tfd.flash_decode_attention_q4(_t(q), rows4, s4, _t(pos), n_head=2, head_dim=64),
         tfd.flash_decode_attention_q4_ref(_t(q), rows4, s4, _t(pos), n_head=2, head_dim=64)),
    ]
    after = (tw4.w4_matmul.launches, tw4.w4_ffn.launches,
             tfd.flash_decode_attention_q8.launches, tfd.flash_decode_attention_q4.launches)
    assert after == before  # no kernel launch on the CPU
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
