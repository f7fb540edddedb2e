"""The split design of the int8 decode kernels (csrc/flash_decode_q8.cu) on
the CPU: its launch plan, and its arithmetic written out here in torch.

- `q8_plan`: the chunk length is a constant of D (never of B or pos), and
  the grid, workspace and counters cover every live chunk, the whole cache
  for a position tensor.
- `_chunked_q8` does what the kernel does: per chunk of `Q8_CHUNK_ROWS[D]`
  rows an exact fp32 softmax (m, l, acc), then the partials of the grid's
  chunks merged in chunk order with weights exp(m_c - max m), chunks that saw
  no row weighing 0. Against the port's plain versions (flat, and stacked
  with the in-flight row) at positions on each side of a chunk boundary, 0,
  S - 1 and per slot, with a caption bias that masks a whole chunk: fp32
  against fp32 in another order of sums, atol 1e-5. Against the JAX
  package's Pallas kernel in interpret mode atol 1e-2: the Pallas kernel
  rounds p * vs and alpha to bf16 (as `test_torch_quant_kernels.py` states).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import quant as jquant
from controlar_tpu.ops import flash_decode2 as jfd
from controlar_tpu_torch import quant as tquant
from controlar_tpu_torch.ops import flash_decode as tfd
from controlar_tpu_torch.ops import flash_decode_stacked as tfds

HEAD_DIMS = (64, 100, 128)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_q8_chunk_length_depends_on_head_dim_only(d, stacked):
    s = 768
    chunks = {tfd.q8_plan(b, s, 12, d, pos, stacked).chunk
              for b in (1, 2, 16, 64)
              for pos in (0, 1, 31, 32, 33, 255, 575, s - 1, s + 3,
                          torch.zeros(b, dtype=torch.int32))}
    assert chunks == {tfd.Q8_CHUNK_ROWS[d]}


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_q8_plan_covers_the_largest_grid(d, stacked):
    b, s, h = 16, 300, 5
    partial = h * (d + 4)  # a (b, chunk)'s partials: acc, m, l and 2 spare floats a head
    full = tfd.q8_plan(b, s, h, d, torch.zeros(b, dtype=torch.int32), stacked)
    # a position tensor: every row of the cache (and the in-flight row)
    assert full.n_chunks * full.chunk >= s + stacked
    assert (full.n_chunks - 1) * full.chunk < s + stacked
    assert full.ws_floats == b * full.n_chunks * partial and full.counters == b * h
    for pos in range(-2, s + 3):
        plan = tfd.q8_plan(b, s, h, d, pos, stacked)
        live = (min(max(pos, 0), s) + 1) if stacked else min(max(pos + 1, 0), s)
        assert plan.n_chunks == max(1, math.ceil(live / plan.chunk))
        assert plan.n_chunks <= full.n_chunks and plan.ws_floats <= full.ws_floats
        assert plan.ws_floats == b * plan.n_chunks * partial and plan.counters == b * h


def _chunked_q8(q, k, v, ks, vs, bias, n_rows, chunk, n_chunks):
    """The kernel's arithmetic for one batch row: q (H, D) fp32; k, v
    (R, H, D), ks, vs (R, H) and bias (R,) over its rows in order; rows
    [0, n_rows) live. Partials per chunk of the grid's n_chunks, merged in
    chunk order."""
    h, d = q.shape
    parts = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n_rows)
        if hi <= lo:  # a chunk that saw no row
            parts.append((torch.full((h,), -math.inf), torch.zeros(h), torch.zeros(h, d)))
            continue
        s = torch.einsum("hd,rhd->rh", q, k[lo:hi]) * ks[lo:hi] * (1.0 / math.sqrt(d))
        s = s + bias[lo:hi, None]
        m = s.amax(0)
        p = torch.exp(s - m)
        parts.append((m, p.sum(0), torch.einsum("rh,rhd->hd", p * vs[lo:hi], v[lo:hi])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = torch.zeros(h, d), torch.zeros(h)
    for m, l, acc in parts:  # chunk order
        w = torch.where(m == -math.inf, torch.zeros(h), torch.exp(m - mx))
        num = num + w[:, None] * acc
        den = den + w * l
    return torch.where(den[:, None] > 0, num / den[:, None], torch.zeros(h, d))


def _split(rows, scale, h):
    """(R, 2*H*D) int8 rows and (R, 2*H) scales -> k, v (R, H, D), ks, vs (R, H)."""
    r = rows.shape[0]
    kv = rows.float().reshape(r, 2, h, -1)
    return kv[:, 0], kv[:, 1], scale[:, :h].float(), scale[:, h:2 * h].float()


def _positions(kind, chunk, s, b):
    """Flat positions: the live rows end on each side of a chunk boundary."""
    if kind == "per_slot":
        return np.array([chunk - 2, chunk, s - 1][:b], np.int32)
    return np.asarray({"chunk-1": chunk - 2, "chunk": chunk - 1, "chunk+1": chunk,
                       "zero": 0, "last": s - 1}[kind], np.int32)


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((b, s, 2 * h * d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((b, h * d)) * 0.5).astype(np.float32)
    new = (rng.standard_normal((b, 2 * h * d)) * 0.5).astype(np.float32)
    return q, kv, new


def _caption_bias(pos, b, s, chunk, with_bias):
    """(B, S) f32, 0 without the bias; with it left padding, as the t2i
    caption's: row 1's first chunk and 3 rows more, row 2's first 2 rows,
    each cut to leave row pos[b] unmasked."""
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
def test_chunked_softmax_matches_plain_version_and_pallas(d, pos_kind, with_bias):
    b, s, h = 3, 128, 2
    chunk = tfd.Q8_CHUNK_ROWS[d]
    q, kv, _ = _inputs(d + len(pos_kind) + with_bias, b, s, h, d)
    pos = _positions(pos_kind, chunk, s, b)
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    rows, scale = jquant.quantize_kv_rows(jnp.asarray(kv), h)
    rows_t, scale_t = _t(rows), _t(scale)
    q_t = _t(q).bfloat16().float()  # the kernel reads q as bf16
    plan = tfd.q8_plan(b, s, h, d, _t(pos), stacked=False)  # the device-pos grid
    pos_b = np.broadcast_to(pos, (b,))
    got = torch.stack([
        _chunked_q8(q_t[i].reshape(h, d), *_split(rows_t[i], scale_t[i], h), _t(bias[i]),
                    int(pos_b[i]) + 1, plan.chunk, plan.n_chunks).reshape(-1)
        for i in range(b)])
    jbias = jnp.asarray(bias) if with_bias else None
    tbias = _t(bias) if with_bias else None
    plain = tfd.flash_decode_attention_q8_ref(_t(q), rows_t, scale_t, _t(pos), tbias, n_head=h)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    pallas = jfd.flash_decode_attention2_q8(jnp.asarray(q), rows, scale, jnp.asarray(pos), jbias,
                                            n_head=h, block=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-2, rtol=0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos_kind", POS_KINDS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_softmax_matches_stacked_plain_version(d, pos_kind, with_bias):
    """The stacked kernel (and the fused append) attend over rows [0, pos)
    of the slab and the in-flight row, which takes no bias: one row more
    than the flat call at the same pos."""
    b, s, h, n_layer, layer = 3, 128, 2, 2, 1
    chunk = tfd.Q8_CHUNK_ROWS[d]
    q, kv, new = _inputs(2 * d + len(pos_kind) + with_bias, b, s, h, d)
    pos = np.clip(_positions(pos_kind, chunk, s, b) + 1, 1, s - 1)  # rows [0, pos] in all
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    stack, sc = tquant.quantize_kv_rows(_t(np.stack([kv * (i + 1) for i in range(n_layer)])), h)
    new_kv, new_s = tquant.quantize_kv_rows(_t(new), h)
    plan = tfd.q8_plan(b, s, h, d, _t(pos), stacked=True)
    q_t = _t(q).bfloat16().float()
    pos_b = np.broadcast_to(pos, (b,))
    got = []
    for i in range(b):
        p = int(pos_b[i])
        rows = torch.cat([stack[layer, i, :p], new_kv[i:i + 1]])
        scale = torch.cat([sc[layer, i, :p], new_s[i:i + 1]])
        brow = torch.cat([_t(bias[i, :p]), torch.zeros(1)])
        got.append(_chunked_q8(q_t[i].reshape(h, d), *_split(rows, scale, h), brow, p + 1,
                               plan.chunk, plan.n_chunks).reshape(-1))
    tbias = _t(bias) if with_bias else None
    plain = tfds.flash_stacked_q8(_t(q), new_kv, new_s, stack, sc, layer, _t(pos), tbias,
                                  n_head=h)
    np.testing.assert_allclose(torch.stack(got).numpy(), plain.numpy(), atol=1e-5, rtol=0)
