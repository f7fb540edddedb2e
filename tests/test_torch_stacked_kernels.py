"""The stacked-cache kernels' plain versions against the JAX package's Pallas
kernels in interpret mode (CPU).

- `flash_stacked`, `flash_stacked_q8`, `flash_stacked_q4` (through their
  wrappers, which take the plain versions for CPU tensors): every layer of
  an L = 3 stack, so that a wrong layer offset fails; bf16 at positions 5,
  200 and 64 with a left-padded bias, q8 at 65 and at per-slot positions
  [1, 65, 100] that cross the 64-row block, q4 split at D = 10 and
  interleaved at D = 16. Tolerance atol 1e-2 on outputs with |o| < 1: the
  Pallas kernels round p and alpha to bf16, which the port keeps in fp32
  (the JAX package's own stacked tests allow 3e-2).
- `cache_append_rows_stacked`: bit for bit on f32, bf16 and int8 rows and
  on f32 scales (unpadded in the port, padded to 128 lanes in JAX).
- The plain versions against the flat plain versions on the layer's slab
  with the in-flight row written: exact.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.ops import cache_append as jca
from controlar_tpu.ops import flash_decode_stacked as jfds
from controlar_tpu_torch import quant as tquant
from controlar_tpu_torch.ops import cache_append as tca
from controlar_tpu_torch.ops import flash_decode as tfd
from controlar_tpu_torch.ops import flash_decode_stacked as tfds

L_STACK = 3


def _t(a):
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _stack_inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((L_STACK, b, s, 2 * h * d)) * 0.5).astype(np.float32)
    new = (rng.standard_normal((b, 2 * h * d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((b, h * d)) * 0.5).astype(np.float32)
    return q, new, kv


def _unpad4(c, h, d):
    """JAX int4 carriers (..., 2 * W) padded per half -> the port's (..., H*D)."""
    c = np.asarray(c)
    return c.reshape(*c.shape[:-1], 2, -1)[..., : h * d // 2].reshape(*c.shape[:-1], h * d)


BF16_CASES = {"pos5": (5, False, False), "pos200": (200, False, False),
              "pos64_bias": (64, True, False), "per_slot_bias": (None, True, True)}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_flash_stacked_matches_pallas(case):
    pos, with_bias, per_slot = BF16_CASES[case]
    b, h, d, s = 2, 4, 32, 256
    q, new, kv = _stack_inputs(len(case), b, s, h, d)
    pos = np.array([3, 130], np.int32) if per_slot else np.asarray(pos, np.int32)
    stack = jnp.asarray(kv, jnp.bfloat16)
    new_b = jnp.asarray(new, jnp.bfloat16)
    bias = None
    if with_bias:
        bias = np.zeros((b, s), np.float32)
        bias[0, :3] = -1e9  # left padding
        bias[1, :2] = -1e9
    before = tfds.flash_stacked.launches
    for layer in range(L_STACK):
        want = jfds.flash_stacked(jnp.asarray(q), new_b, stack, jnp.asarray(layer),
                                  jnp.asarray(pos), None if bias is None else jnp.asarray(bias),
                                  n_head=h, block=64, interpret=True)
        got = tfds.flash_stacked(_t(q), _t(new_b), _t(stack), layer, _t(pos),
                                 None if bias is None else _t(bias), n_head=h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    assert tfds.flash_stacked.launches == before  # the plain version on the CPU


@pytest.mark.parametrize("pos", [65, [1, 65, 100]])
def test_flash_stacked_q8_matches_pallas(pos):
    b, h, d, s = 3, 2, 16, 128
    q, new, kv = _stack_inputs(7, b, s, h, d)
    rows, scales = jquant.quantize_kv_rows(jnp.asarray(kv), h)
    new_rows, new_s = jquant.quantize_kv_rows(jnp.asarray(new), h)
    pos = np.asarray(pos, np.int32)
    for layer in range(L_STACK):
        want = jfds.flash_stacked_q8(
            jnp.asarray(q), new_rows, jdec._pad_scales(new_s, h), rows,
            jdec._pad_scales(scales, h), jnp.asarray(layer), jnp.asarray(pos), None,
            n_head=h, block=64, interpret=True)
        got = tfds.flash_stacked_q8(_t(q), _t(new_rows), _t(new_s), _t(rows), _t(scales), layer,
                                    _t(pos), n_head=h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize("split,d", [(True, 10), (False, 16)])
@pytest.mark.parametrize("pos", [33, [1, 33, 70]])
def test_flash_stacked_q4_matches_pallas(split, d, pos):
    b, h, s = 3, 2, 128
    q, new, kv = _stack_inputs(d, b, s, h, d)
    rows, scales = jquant.quantize_kv_rows_4(jnp.asarray(kv), h, split=split)
    new_rows, new_s = jquant.quantize_kv_rows_4(jnp.asarray(new), h, split=split)
    pos = np.asarray(pos, np.int32)
    for layer in range(L_STACK):
        want = jfds.flash_stacked_q4(
            jnp.asarray(q), new_rows, jdec._pad_scales(new_s, h), rows,
            jdec._pad_scales(scales, h), jnp.asarray(layer), jnp.asarray(pos), None,
            n_head=h, head_dim=d, block=64, interpret=True, split=split)
        got = tfds.flash_stacked_q4(_t(q), _t(_unpad4(new_rows, h, d)), _t(new_s),
                                    _t(_unpad4(rows, h, d)), _t(scales), layer, _t(pos),
                                    n_head=h, head_dim=d, split=split)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize("kind", ["bf16", "q8", "q4"])
def test_plain_versions_equal_the_flat_ones_on_the_written_slab(kind):
    """Row pos[b] scored from the operand, the bias of column pos[b] not
    applied: the flat plain version over the written slab with that column
    of the bias at 0 gives the same numbers, bit for bit."""
    b, h, d, s = 4, 2, 64, 48
    q, new, kv = (torch.from_numpy(a) for a in _stack_inputs(11, b, s, h, d))
    pos = torch.tensor([0, 1, 20, 47], dtype=torch.int32)
    bias = torch.where(torch.arange(s)[None, :] < torch.tensor([0, 0, 3, 9])[:, None],
                       -1e9, 0.0).float()
    layer = 1
    idx = torch.arange(b), pos.long()
    flat_bias = bias.clone()
    flat_bias[idx] = 0.0
    if kind == "bf16":
        stack, row = kv.bfloat16(), new.bfloat16()
        slab = stack[layer].clone()
        slab[idx] = row
        got = tfds.flash_stacked(q, row, stack, layer, pos, bias, n_head=h)
        want = tfd.flash_decode_attention_ref(q, slab, pos, flat_bias, n_head=h)
    else:
        fn = tquant.quantize_kv_rows if kind == "q8" else tquant.quantize_kv_rows_4
        stack, sc = fn(kv, h)
        row, row_s = fn(new, h)
        slab, slab_s = stack[layer].clone(), sc[layer].clone()
        slab[idx], slab_s[idx] = row, row_s
        if kind == "q8":
            got = tfds.flash_stacked_q8(q, row, row_s, stack, sc, layer, pos, bias, n_head=h)
            want = tfd.flash_decode_attention_q8_ref(q, slab, slab_s, pos, flat_bias, n_head=h)
        else:
            got = tfds.flash_stacked_q4(q, row, row_s, stack, sc, layer, pos, bias, n_head=h,
                                        head_dim=d)
            want = tfd.flash_decode_attention_q4_ref(q, slab, slab_s, pos, flat_bias,
                                                     n_head=h, head_dim=d)
    assert torch.equal(got, want)


def test_plain_versions_refuse_a_position_outside_the_cache():
    q, new, kv = (torch.from_numpy(a) for a in _stack_inputs(12, 2, 16, 2, 64))
    with pytest.raises(IndexError):
        tfds.flash_stacked(q, new.bfloat16(), kv.bfloat16(), 0, 16, n_head=2)


# ---- B13: the stacked row append ---------------------------------------------

S_APPEND = 64
POSITIONS = np.array([0, 5, 31, 32, 40, S_APPEND - 1], np.int32)

# stream: (JAX dtype, width in the JAX cache, width in the port's)
STREAMS = {
    "f32_rows": (jnp.float32, 256, 256),
    "bf16_rows": (jnp.bfloat16, 256, 256),
    "int8_rows": (jnp.int8, 256, 256),
    "f32_scales": (jnp.float32, 128, 6),  # JAX pads 2H to 128 lanes
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_cache_append_stacked_matches_pallas_bit_for_bit(stream):
    jdt, wj, wt = STREAMS[stream]
    rng = np.random.default_rng(len(stream))
    b = len(POSITIONS)
    if jdt == jnp.int8:
        cache = rng.integers(-127, 128, (L_STACK, b, S_APPEND, wj)).astype(np.int8)
        rows = rng.integers(-127, 128, (L_STACK, b, wj)).astype(np.int8)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal((L_STACK, b, S_APPEND, wj)), jdt))
        rows = np.asarray(jnp.asarray(rng.standard_normal((L_STACK, b, wj)) * 3, jdt))
    want = np.asarray(jca.cache_append_rows_stacked(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(POSITIONS), interpret=True))
    expect = cache.copy()
    expect[:, np.arange(b), POSITIONS] = rows
    np.testing.assert_array_equal(want.view(np.uint8), expect.view(np.uint8))

    got = _t(cache)[..., :wt].contiguous()
    before = tca.cache_append_rows_stacked.launches
    out = tca.cache_append_rows_stacked(got, _t(rows)[..., :wt], torch.from_numpy(POSITIONS))
    assert out is got and tca.cache_append_rows_stacked.launches == before
    bits = torch.int16 if jdt == jnp.bfloat16 else torch.uint8
    np.testing.assert_array_equal(got.view(bits).numpy(),
                                  _t(want)[..., :wt].contiguous().view(bits).numpy())


def test_cache_append_stacked_plain_version_refuses_a_position_outside_the_cache():
    cache = torch.zeros(2, 3, 8, 4)
    with pytest.raises(IndexError):
        tca.cache_append_rows_stacked(cache, torch.ones(2, 3, 4),
                                      torch.tensor([0, 8, 2], dtype=torch.int32))
    assert cache.abs().sum() == 0


def test_cache_append_stacked_casts_rows_to_the_cache_dtype():
    cache = torch.zeros(2, 2, 4, 3, dtype=torch.bfloat16)
    rows = torch.randn(2, 2, 3, generator=torch.Generator().manual_seed(0))
    tca.cache_append_rows_stacked(cache, rows, torch.tensor([3, 0], dtype=torch.int32))
    assert torch.equal(cache[:, 0, 3], rows[:, 0].bfloat16())
    assert torch.equal(cache[:, 1, 0], rows[:, 1].bfloat16())
    assert cache.float().abs().sum() == rows.bfloat16().float().abs().sum()
