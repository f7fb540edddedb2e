"""The speculative-decode kernels' plain versions against the JAX package's
Pallas kernels, run in interpret mode on the CPU.

- chunk attention (bf16, int8, int4 split and interleaved): K queries per
  row at per-row positions that cross a 64-row block, with and without a
  left-padded column bias that also masks some queries' own rows (the
  diagonal exception keeps them finite). The Pallas kernels round p and
  alpha to bf16 before the value products, which the port keeps in fp32;
  outputs of |o| < 1 agree to 1e-2 (the JAX package's own chunk tests allow
  3e-2, its q8 decode test 2e-2);
- the K-row block append, bit for bit on bf16 rows, int8 rows and f32
  scales.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import quant as jquant
from controlar_tpu.ops import cache_append as jca
from controlar_tpu.ops import flash_chunk as jfc
from controlar_tpu_torch import quant as tquant
from controlar_tpu_torch.ops import cache_append as tca
from controlar_tpu_torch.ops import flash_chunk as tfc

ATOL = 1e-2
B, S, H = 3, 128, 2
POS = np.array([0, 60, 100], np.int32)  # row 1's chunk crosses the 64-row block


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, k, d, with_bias):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((B, S, 2 * H * d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((B, k, H * d)) * 0.5).astype(np.float32)
    bias = None
    if with_bias:
        # left padding over the first 1, 4 and 9 columns: row 0's first
        # query sees only its own, masked, row
        pad = np.array([1, 4, 9])
        bias = np.where(np.arange(S)[None, :] < pad[:, None], -1e9, 0.0).astype(np.float32)
    return q, kv, bias


def _opt(a):
    return None if a is None else _t(a)


def _jopt(a):
    return None if a is None else jnp.asarray(a)


CASES = [(k, d, with_bias) for k in (1, 2, 4, 8) for d in (64, 100) for with_bias in (False, True)]


@pytest.mark.parametrize("k,d,with_bias", CASES)
def test_chunk_plain_version_matches_pallas_kernel(k, d, with_bias):
    q, kv, bias = _inputs(k * d, k, d, with_bias)
    want = jfc.flash_chunk_attention(jnp.asarray(q), jnp.asarray(kv, jnp.bfloat16),
                                     jnp.asarray(POS), _jopt(bias), n_head=H, block=64,
                                     interpret=True)
    kv_bf = _t(np.asarray(jnp.asarray(kv, jnp.bfloat16).astype(jnp.float32))).bfloat16()
    got = tfc.flash_chunk_attention_ref(_t(q), kv_bf, _t(POS), _opt(bias), n_head=H)
    assert got.shape == (B, k, H * d) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k,with_bias", [(1, True), (4, False), (4, True), (8, True)])
def test_chunk_q8_plain_version_matches_pallas_kernel(k, with_bias):
    d = 64
    q, kv, bias = _inputs(3 + k, k, d, with_bias)
    rows, scale = jquant.quantize_kv_rows(jnp.asarray(kv), H)
    want = jfc.flash_chunk_attention_q8(jnp.asarray(q), rows, scale, jnp.asarray(POS),
                                        _jopt(bias), n_head=H, block=64, interpret=True)
    got = tfc.flash_chunk_attention_q8_ref(_t(q), _t(rows), _t(scale), _t(POS), _opt(bias),
                                           n_head=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("k,d,with_bias", [(1, 64, True), (4, 64, False), (4, 100, True),
                                           (8, 100, False), (2, 64, True)])
def test_chunk_q4_plain_version_matches_pallas_kernel(split, k, d, with_bias):
    """The JAX slab pads each half of a row to 128 bytes; the port's does not."""
    q, kv, bias = _inputs(7 * k + d, k, d, with_bias)
    carriers, scale = jquant.quantize_kv_rows_4(jnp.asarray(kv), H, split=split)
    want = jfc.flash_chunk_attention_q4(jnp.asarray(q), carriers, scale, jnp.asarray(POS),
                                        _jopt(bias), n_head=H, head_dim=d, block=64,
                                        interpret=True, split=split)
    half = H * d // 2
    rows = np.asarray(carriers).reshape(B, S, 2, -1)[..., :half].reshape(B, S, -1)
    got = tfc.flash_chunk_attention_q4_ref(_t(q), _t(rows), _t(scale), _t(POS), _opt(bias),
                                           n_head=H, head_dim=d, split=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_chunk_query_sees_rows_up_to_its_own():
    """Query j of a chunk equals a one-query attention at position pos + j,
    except that the bias is not added on its own row."""
    q, kv, bias = _inputs(5, 4, 64, True)
    kv_t, q_t, bias_t = _t(kv).bfloat16(), _t(q), _t(bias)
    got = tfc.flash_chunk_attention_ref(q_t, kv_t, _t(POS), bias_t, n_head=H)
    from controlar_tpu_torch.ops.flash_decode import flash_decode_attention_ref

    for j in range(4):
        own = torch.from_numpy(POS + j)
        diag = bias_t.clone()
        diag[torch.arange(B), own.long()] = 0.0
        want = flash_decode_attention_ref(q_t[:, j], kv_t, own.int(), diag, n_head=H)
        torch.testing.assert_close(got[:, j], want, rtol=1e-6, atol=1e-6)


def test_chunk_wrappers_on_the_cpu_are_the_plain_versions():
    q, kv, bias = _inputs(9, 4, 64, True)
    rows8, s8 = tquant.quantize_kv_rows(_t(kv), H)
    rows4, s4 = tquant.quantize_kv_rows_4(_t(kv), H, split=True)
    kv_bf = _t(kv).bfloat16()
    wrappers = (tfc.flash_chunk_attention, tfc.flash_chunk_attention_q8,
                tfc.flash_chunk_attention_q4)
    before = [f.launches for f in wrappers]
    pairs = [
        (tfc.flash_chunk_attention(_t(q), kv_bf, _t(POS), _t(bias), n_head=H),
         tfc.flash_chunk_attention_ref(_t(q), kv_bf, _t(POS), _t(bias), n_head=H)),
        (tfc.flash_chunk_attention_q8(_t(q), rows8, s8, _t(POS), n_head=H),
         tfc.flash_chunk_attention_q8_ref(_t(q), rows8, s8, _t(POS), n_head=H)),
        (tfc.flash_chunk_attention_q4(_t(q), rows4, s4, _t(POS), n_head=H, head_dim=64,
                                      split=True),
         tfc.flash_chunk_attention_q4_ref(_t(q), rows4, s4, _t(POS), n_head=H, head_dim=64,
                                          split=True)),
    ]
    assert [f.launches for f in wrappers] == before  # no kernel launch on the CPU
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- the K-row block append --------------------------------------------------

K_APPEND = 4
# the blocks and the JAX kernel's read-modify-write windows around them (8 rows
# for 4- and 2-byte types, 32 for int8) lie inside the 128-row cache; the block
# at 29 spans two windows
APPEND_POS = np.array([0, 7, 29, 60], np.int32)
# stream: (JAX dtype, the port's, width in the JAX cache, width in the port's)
STREAMS = {
    "bf16_rows": (jnp.bfloat16, torch.bfloat16, 256, 256),
    "int8_rows": (jnp.int8, torch.int8, 256, 256),
    "f32_scales": (jnp.float32, torch.float32, 128, 6),  # JAX pads 2H to 128 lanes
}


def _pallas_append_block(cache, rows, pos):
    """The JAX package's kernel, run in interpret mode by a patched
    pallas_call (the package itself is unchanged)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        fn = getattr(jca.cache_append_block, "__wrapped__", jca.cache_append_block)
        return np.asarray(fn(cache, rows, pos))
    finally:
        pl.pallas_call = orig


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8).numpy()


@pytest.mark.parametrize("stream", list(STREAMS))
def test_cache_append_block_matches_pallas_bit_for_bit(stream):
    jdt, tdt, wj, wt = STREAMS[stream]
    rng = np.random.default_rng(len(stream) + 1)
    b = len(APPEND_POS)
    if jdt == jnp.int8:
        cache = rng.integers(-127, 128, (b, S, wj)).astype(np.int8)
        rows = rng.integers(-127, 128, (b, K_APPEND, wj)).astype(np.int8)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal((b, S, wj)), jdt))
        rows = np.asarray(jnp.asarray(rng.standard_normal((b, K_APPEND, wj)) * 3, jdt))
    want = _pallas_append_block(jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(APPEND_POS))
    # the Pallas kernel changes exactly the rows pos[b] .. pos[b] + K - 1
    expect = cache.copy()
    for i, p in enumerate(APPEND_POS):
        expect[i, p:p + K_APPEND] = rows[i]
    np.testing.assert_array_equal(want.view(np.uint8), expect.view(np.uint8))

    def torch_of(a):
        t = _t(a.view(np.int16)).view(torch.bfloat16) if jdt == jnp.bfloat16 else _t(a)
        return t[..., :wt].contiguous()

    got = torch_of(cache)
    before = tca.cache_append_block.launches
    out = tca.cache_append_block(got, torch_of(rows), _t(APPEND_POS))
    assert out is got and tca.cache_append_block.launches == before  # plain path on the CPU
    np.testing.assert_array_equal(_bits(got), _bits(torch_of(want)))


def test_cache_append_block_at_the_end_and_out_of_range():
    cache = torch.zeros(2, 16, 3)
    rows = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    tca.cache_append_block_ref(cache, rows, torch.tensor([12, 0], dtype=torch.int32))
    assert torch.equal(cache[0, 12:], rows[0]) and torch.equal(cache[1, :4], rows[1])
    assert cache.abs().sum() == rows.abs().sum()
    for bad in ([13, 0], [-1, 0]):
        with pytest.raises(IndexError):
            tca.cache_append_block_ref(cache, rows, torch.tensor(bad, dtype=torch.int32))


def test_cache_append_block_casts_rows_to_the_cache_dtype():
    cache = torch.zeros(1, 8, 2, dtype=torch.bfloat16)
    rows = torch.tensor([[[1.0, 3.00390625], [4.0, 5.0]]])
    tca.cache_append_block(cache, rows, torch.tensor([3], dtype=torch.int32))
    assert torch.equal(cache[0, 3:5], rows[0].bfloat16())
