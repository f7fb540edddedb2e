"""The split design of the bf16 decode kernels (csrc/flash_decode.cu: B1
`flash_decode_attention` and the stacked B12-bf16 `flash_stacked`) on the
CPU: its launch plan, and its arithmetic written out here in torch.

- `split_plan` over a bf16 cache: the chunk length is a constant of D
  (never of B or pos), and the grid, workspace and counters cover every
  live chunk, the whole cache for a position tensor.
- `_chunked` does what the kernel does: per chunk of
  `CHUNK_ROWS[torch.bfloat16][D]` rows an fp32 online softmax in 8-row
  stages whose running max m moves only when a score passes it by 2^8
  (the kernel's lazy max), giving (m, l, acc), then the partials of the
  grid's chunks merged in chunk order with weights exp(m_c - max m),
  chunks that saw no row weighing 0. Against the port's
  plain versions (flat, and stacked with the in-flight row) at positions on
  each side of a chunk boundary, 0, S - 1 and per slot, with a caption bias
  that masks a whole chunk: fp32 against fp32 in another order of sums,
  atol 1e-5. Against the JAX package's Pallas kernels in interpret mode
  atol 2e-2: the Pallas kernels round p and alpha to bf16 (as
  `test_torch_flash_decode.py` states).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu.ops import flash_decode2 as jfd
from controlar_tpu.ops import flash_decode_stacked as jfds
from controlar_tpu_torch.ops import flash_decode as tfd
from controlar_tpu_torch.ops import flash_decode_stacked as tfds

HEAD_DIMS = (64, 100, 128)
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_chunk_length_depends_on_head_dim_only(d, stacked):
    s = 768
    chunks = {tfd.split_plan(b, s, 12, d, pos, stacked, BF16).chunk
              for b in (1, 2, 16, 64)
              for pos in (0, 1, 31, 32, 33, 63, 64, 65, 255, 575, s - 1, s + 3,
                          torch.zeros(b, dtype=torch.int32))}
    assert chunks == {tfd.CHUNK_ROWS[BF16][d]}


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_plan_covers_the_largest_grid(d, stacked):
    b, s, h = 16, 300, 5
    partial = h * (d + 4)  # a (b, chunk)'s partials: acc, m, l and 2 spare floats a head
    full = tfd.split_plan(b, s, h, d, torch.zeros(b, dtype=torch.int32), stacked, BF16)
    # a position tensor: every row of the cache (and the in-flight row)
    assert full.n_chunks * full.chunk >= s + stacked
    assert (full.n_chunks - 1) * full.chunk < s + stacked
    assert full.ws_floats == b * full.n_chunks * partial and full.counters == b * h
    for pos in range(-2, s + 3):
        plan = tfd.split_plan(b, s, h, d, pos, stacked, BF16)
        live = (min(max(pos, 0), s) + 1) if stacked else min(max(pos + 1, 0), s)
        assert plan.n_chunks == max(1, math.ceil(live / plan.chunk))
        assert plan.n_chunks <= full.n_chunks and plan.ws_floats <= full.ws_floats
        assert plan.ws_floats == b * plan.n_chunks * partial and plan.counters == b * h


def _chunked(q, k, v, bias, n_rows, chunk, n_chunks):
    """The kernel's arithmetic for one batch row: q (H, D) fp32; k, v
    (R, H, D) and bias (R,) over its rows in order; rows [0, n_rows) live.
    Partials per chunk of the grid's n_chunks, each an online softmax over
    8-row stages with the kernel's lazy max, merged in chunk order."""
    h, d = q.shape
    slack = 8 * math.log(2)  # the kernel's 2^8, in natural-log units
    parts = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n_rows)
        m, l, acc = torch.full((h,), -math.inf), torch.zeros(h), torch.zeros(h, d)
        for st in range(lo, hi, 8):
            rows = slice(st, min(st + 8, hi))
            s = torch.einsum("hd,rhd->rh", q, k[rows]) * (1.0 / math.sqrt(d)) + bias[rows, None]
            m_new = torch.where((s > m + slack).any(0), torch.maximum(m, s.amax(0)), m)
            alpha = torch.exp(m - m_new).nan_to_num(1.0)  # exp(-inf - -inf): no row yet
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(0)
            acc = acc * alpha[:, None] + torch.einsum("rh,rhd->hd", p, v[rows])
            m = m_new
        parts.append((m, l, acc))  # m = -inf, l = 0: a chunk that saw no row
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = torch.zeros(h, d), torch.zeros(h)
    for m, l, acc in parts:  # chunk order
        w = torch.where(m == -math.inf, torch.zeros(h), torch.exp(m - mx))
        num = num + w[:, None] * acc
        den = den + w * l
    return torch.where(den[:, None] > 0, num / den[:, None], torch.zeros(h, d))


def _split(rows, h):
    """(R, 2*H*D) rows -> k, v (R, H, D) fp32."""
    kv = rows.float().reshape(rows.shape[0], 2, h, -1)
    return kv[:, 0], kv[:, 1]


def _positions(kind, chunk, s, b):
    """Flat positions: the live rows (pos + 1) end on each side of a chunk
    boundary, or 0, S - 1 and per slot."""
    if kind == "per_slot":
        return np.array([chunk - 2, chunk, s - 1][:b], np.int32)
    return np.asarray({"chunk-1": chunk - 2, "chunk": chunk - 1, "chunk+1": chunk,
                       "zero": 0, "last": s - 1}[kind], np.int32)


def _inputs(seed, b, s, h, d, n_layer=1):
    """q, the cache (L, B, S, 2*H*D) and the in-flight row, bf16-valued fp32."""
    rng = np.random.default_rng(seed)
    bf = lambda x: np.asarray(jnp.asarray(x * 0.5, jnp.bfloat16), np.float32)  # noqa: E731
    return (bf(rng.standard_normal((b, h * d))), bf(rng.standard_normal((n_layer, b, s, 2 * h * d))),
            bf(rng.standard_normal((b, 2 * h * d))))


def _caption_bias(pos, b, s, chunk, with_bias):
    """(B, S) f32, 0 without the bias; with it left padding, as the t2i
    caption's: row 1's whole first chunk and 3 rows more, row 2's first 2
    rows, each cut to leave row pos[b] unmasked."""
    bias = np.zeros((b, s), np.float32)
    pos_b = np.broadcast_to(pos, (b,))
    for i, pad in ((1, chunk + 3), (2, 2)):
        if with_bias and i < b:
            bias[i, :min(pad, int(pos_b[i]))] = -1e9
    return bias


POS_KINDS = ("chunk-1", "chunk", "chunk+1", "zero", "last", "per_slot")


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos_kind", POS_KINDS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_chunked_softmax_matches_plain_version_and_pallas(d, pos_kind, with_bias):
    b, s, h = 3, 320, 2  # past two of the largest chunk
    chunk = tfd.CHUNK_ROWS[BF16][d]
    q, kv, _ = _inputs(d + len(pos_kind) + with_bias, b, s, h, d)
    kv = kv[0]
    pos = _positions(pos_kind, chunk, s, b)
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    plan = tfd.split_plan(b, s, h, d, _t(pos), False, BF16)  # the device-pos grid
    pos_b = np.broadcast_to(pos, (b,))
    got = torch.stack([
        _chunked(_t(q[i]).reshape(h, d), *_split(_t(kv[i]), h), _t(bias[i]), int(pos_b[i]) + 1,
                 plan.chunk, plan.n_chunks).reshape(-1)
        for i in range(b)])
    tbias = _t(bias) if with_bias else None
    plain = tfd.flash_decode_attention_ref(_t(q), _t(kv).bfloat16(), _t(pos), tbias, n_head=h)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    pallas = jfd.flash_decode_attention2(
        jnp.asarray(q), jnp.asarray(kv, jnp.bfloat16), jnp.asarray(pos),
        jnp.asarray(bias) if with_bias else None, n_head=h, block=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32), atol=2e-2, rtol=0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos_kind", POS_KINDS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_chunked_softmax_matches_stacked_plain_version_and_pallas(d, pos_kind, with_bias):
    """The stacked kernel attends over rows [0, pos) of the layer's slab and
    the in-flight row, which takes no bias: one row more than the flat call
    at the same pos."""
    b, s, h, n_layer, layer = 3, 320, 2, 2, 1
    chunk = tfd.CHUNK_ROWS[BF16][d]
    q, stack, new = _inputs(2 * d + len(pos_kind) + with_bias, b, s, h, d, n_layer)
    pos = np.clip(_positions(pos_kind, chunk, s, b) + 1, 1, s - 1)  # rows [0, pos] in all
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    plan = tfd.split_plan(b, s, h, d, _t(pos), True, BF16)
    pos_b = np.broadcast_to(pos, (b,))
    got = []
    for i in range(b):
        p = int(pos_b[i])
        rows = torch.cat([_t(stack[layer, i, :p]), _t(new[i:i + 1])])
        brow = torch.cat([_t(bias[i, :p]), torch.zeros(1)])
        got.append(_chunked(_t(q[i]).reshape(h, d), *_split(rows, h), brow, p + 1, plan.chunk,
                            plan.n_chunks).reshape(-1))
    got = torch.stack(got).numpy()
    tbias = _t(bias) if with_bias else None
    plain = tfds.flash_stacked_ref(_t(q), _t(new).bfloat16(), _t(stack).bfloat16(), layer, _t(pos),
                                   tbias, n_head=h)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)
    pallas = jfds.flash_stacked(
        jnp.asarray(q), jnp.asarray(new, jnp.bfloat16), jnp.asarray(stack, jnp.bfloat16),
        jnp.asarray(layer), jnp.asarray(pos), jnp.asarray(bias) if with_bias else None,
        n_head=h, block=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=2e-2, rtol=0)
