"""The split design of the int4 decode kernels (csrc/flash_decode_q4.cu: B3
`flash_decode_attention_q4` and the stacked B12-q4 `flash_stacked_q4`) on
the CPU: its launch plan, and its arithmetic written out here in torch.

- `split_plan` over the int4 cache (its own key, `INT4`: the carriers are
  torch.int8, whose plan is the int8 kernel's): the chunk length is a
  constant of D (never of B or pos), the kernel's own (the source's
  defaults), and the grid, workspace and counters cover every live chunk,
  the whole cache for a position tensor.
- `_chunked_q4` does what the kernel does: per chunk of
  `CHUNK_ROWS[INT4][D]` rows an fp32 online softmax over the nibbles in
  8-row stages whose running max moves only when a score passes it by 2^8
  (the kernel's lazy max), the v scale folded into p, giving (m, l, acc),
  then the partials of the grid's chunks merged in chunk order with weights
  exp(m_c - max m), chunks that saw no row weighing 0. Against the port's
  plain versions (flat, and stacked with the in-flight row), split-rope and
  interleaved pairs, D 64/100/128, at positions on each side of a chunk
  boundary, 0, S - 1 and per slot, with a caption bias that masks a whole
  chunk: fp32 against fp32 in another order of sums, atol 1e-5. Against the
  JAX package's Pallas kernels in interpret mode atol 1e-2: they round
  p * vs and alpha to bf16 (as `test_torch_quant_kernels.py` states).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.ops import flash_decode2 as jfd
from controlar_tpu.ops import flash_decode_stacked as jfds
from controlar_tpu_torch.ops import flash_decode as tfd
from controlar_tpu_torch.ops import flash_decode_stacked as tfds
from controlar_tpu_torch.ops.w4_matmul import unpack_nibbles

HEAD_DIMS = (64, 100, 128)
INT4 = tfd.INT4
SOURCE = Path(tfd.__file__).resolve().parent.parent / "csrc" / "flash_decode_q4.cu"


def _t(a):
    return torch.from_numpy(np.array(a))


def test_q4_chunk_lengths_are_the_kernels_own():
    """CHUNK_ROWS[INT4] holds the length the kernel is built with at every D
    (it refuses any other): `chunk::kChunk` of the shared template, under
    its own key: the int8 lengths are another entry, so a plan read from the
    carriers' dtype would be int8's."""
    assert re.search(r"static constexpr int CHUNK = chunk::kChunk;", SOURCE.read_text())
    (k_chunk,) = re.findall(r"constexpr int kChunk = (\d+);",
                            SOURCE.with_name("flash_chunk.cuh").read_text())
    assert tfd.CHUNK_ROWS[INT4] == dict.fromkeys(HEAD_DIMS, int(k_chunk))
    assert int(k_chunk) % 32 == 0
    assert INT4 != torch.int8 and tfd.CHUNK_ROWS[INT4] is not tfd.CHUNK_ROWS[torch.int8]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_q4_chunk_length_depends_on_head_dim_only(d, stacked):
    s = 768
    chunks = {tfd.split_plan(b, s, 12, d, pos, stacked, INT4).chunk
              for b in (1, 2, 16, 64)
              for pos in (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 255, 575, s - 1, s + 3,
                          torch.zeros(b, dtype=torch.int32))}
    assert chunks == {tfd.CHUNK_ROWS[INT4][d]}


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_q4_plan_is_not_the_int8_plan_by_default(d):
    """Where the int4 and int8 lengths agree (D 64: 64 rows, the probe's
    choice for both, PERF.md) the plans are equal by choice; at D 100 and
    128 they differ, so a q4 call given int8's plan would launch 32-row
    chunks into a kernel built for 64 (which refuses it)."""
    b, s, h = 16, 768, 32
    for pos in (0, 100, 575, torch.zeros(b, dtype=torch.int32)):
        q4 = tfd.split_plan(b, s, h, d, pos, False, INT4)
        q8 = tfd.split_plan(b, s, h, d, pos, False, torch.int8)
        assert q4.chunk == tfd.CHUNK_ROWS[INT4][d]
        assert (q4 == q8) == (tfd.CHUNK_ROWS[INT4][d] == tfd.CHUNK_ROWS[torch.int8][d])
    assert tfd.CHUNK_ROWS[INT4][d] != tfd.CHUNK_ROWS[torch.int8][d] or d == 64


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("stacked", [False, True])
def test_q4_plan_covers_the_largest_grid(d, stacked):
    b, s, h = 16, 300, 5
    partial = h * (d + 4)  # a (b, chunk)'s partials: acc, m, l and 2 spare floats a head
    full = tfd.split_plan(b, s, h, d, torch.zeros(b, dtype=torch.int32), stacked, INT4)
    # a position tensor: every row of the cache (and the in-flight row)
    assert full.n_chunks * full.chunk >= s + stacked
    assert (full.n_chunks - 1) * full.chunk < s + stacked
    assert full.ws_floats == b * full.n_chunks * partial and full.counters == b * h
    for pos in range(-2, s + 3):
        plan = tfd.split_plan(b, s, h, d, pos, stacked, INT4)
        live = (min(max(pos, 0), s) + 1) if stacked else min(max(pos + 1, 0), s)
        assert plan.n_chunks == max(1, math.ceil(live / plan.chunk))
        assert plan.n_chunks <= full.n_chunks and plan.ws_floats <= full.ws_floats
        assert plan.ws_floats == b * plan.n_chunks * partial and plan.counters == b * h


def _chunked_q4(qe, qo, k, v, ks, vs, bias, n_rows, chunk, n_chunks, split):
    """The kernel's arithmetic for one batch row: qe, qo (H, D/2) fp32, q's
    even and odd pair halves; k, v (R, H, D/2) int32 carriers, ks, vs (R, H)
    and bias (R,) over its rows in order; rows [0, n_rows) live. Partials per
    chunk of the grid's n_chunks, each an online softmax over 8-row stages
    with the kernel's lazy max, merged in chunk order; the output pairs put
    back in q's layout."""
    h, half = qe.shape
    klo, khi = (x.float() for x in unpack_nibbles(k))
    vlo, vhi = (x.float() for x in unpack_nibbles(v))
    slack = 8 * math.log(2)  # the kernel's 2^8, in natural-log units
    parts = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, n_rows)
        m, l = torch.full((h,), -math.inf), torch.zeros(h)
        acc_e, acc_o = torch.zeros(h, half), torch.zeros(h, half)
        for st in range(lo, hi, 8):
            rows = slice(st, min(st + 8, hi))
            s = (torch.einsum("hj,rhj->rh", qe, klo[rows])
                 + torch.einsum("hj,rhj->rh", qo, khi[rows]))
            s = s * ks[rows] * (1.0 / math.sqrt(2 * half)) + bias[rows, None]
            m_new = torch.where((s > m + slack).any(0), torch.maximum(m, s.amax(0)), m)
            alpha = torch.exp(m - m_new).nan_to_num(1.0)  # exp(-inf - -inf): no row yet
            p = torch.exp(s - m_new)
            pv = p * vs[rows]  # the v scale folded into p
            l = l * alpha + p.sum(0)
            acc_e = acc_e * alpha[:, None] + torch.einsum("rh,rhj->hj", pv, vlo[rows])
            acc_o = acc_o * alpha[:, None] + torch.einsum("rh,rhj->hj", pv, vhi[rows])
            m = m_new
        parts.append((m, l, acc_e, acc_o))  # m = -inf, l = 0: a chunk that saw no row
    mx = torch.stack([p[0] for p in parts]).amax(0)
    num_e, num_o, den = torch.zeros(h, half), torch.zeros(h, half), torch.zeros(h)
    for m, l, acc_e, acc_o in parts:  # chunk order
        w = torch.where(m == -math.inf, torch.zeros(h), torch.exp(m - mx))
        num_e = num_e + w[:, None] * acc_e
        num_o = num_o + w[:, None] * acc_o
        den = den + w * l
    o_e, o_o = (torch.where(den[:, None] > 0, n / den[:, None], torch.zeros(h, half))
                for n in (num_e, num_o))
    return (torch.cat([o_e, o_o], -1) if split else torch.stack([o_e, o_o], -1)).reshape(-1)


def _split(rows, scale, h):
    """(R, H*D) carriers and (R, 2*H) scales -> k, v (R, H, D/2) int32, ks, vs (R, H)."""
    c = rows.to(torch.int32).reshape(rows.shape[0], 2, h, -1)
    return c[:, 0], c[:, 1], scale[:, :h].float(), scale[:, h:2 * h].float()


def _positions(kind, chunk, s, b):
    """Flat positions: the live rows (pos + 1) end on each side of a chunk
    boundary, or 0, S - 1 and per slot."""
    if kind == "per_slot":
        return np.array([chunk - 2, chunk, s - 1][:b], np.int32)
    return np.asarray({"chunk-1": chunk - 2, "chunk": chunk - 1, "chunk+1": chunk,
                       "zero": 0, "last": s - 1}[kind], np.int32)


def _inputs(seed, b, s, h, d, split, n_layer=1):
    """q (B, H*D) f32; the JAX carriers (padded) and scales of an
    (L, B, S, 2*H*D) cache and of the in-flight rows; the port's (unpadded)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h * d)) * 0.5).astype(np.float32)
    kv = (rng.standard_normal((n_layer, b, s, 2 * h * d)) * 0.5).astype(np.float32)
    new = (rng.standard_normal((b, 2 * h * d)) * 0.5).astype(np.float32)
    jax_rows = jquant.quantize_kv_rows_4(jnp.asarray(kv), h, split=split)
    jax_new = jquant.quantize_kv_rows_4(jnp.asarray(new), h, split=split)
    half = h * d // 2
    unpad = lambda c: _t(np.asarray(c).reshape(*c.shape[:-1], 2, -1)[..., :half]  # noqa: E731
                         .reshape(*c.shape[:-1], 2 * half))
    port = (unpad(jax_rows[0]), _t(jax_rows[1]), unpad(jax_new[0]), _t(jax_new[1]))
    return q, jax_rows, jax_new, port


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


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos_kind", POS_KINDS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_q4_chunked_softmax_matches_plain_version_and_pallas(split, d, pos_kind, with_bias):
    b, s, h = 3, 320, 2  # past two of the largest chunk, a multiple of the Pallas block
    chunk = tfd.CHUNK_ROWS[INT4][d]
    q, jax_rows, _, (rows, scale, _, _) = _inputs(d + len(pos_kind) + with_bias, b, s, h, d, split)
    rows, scale = rows[0], scale[0]
    pos = _positions(pos_kind, chunk, s, b)
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    plan = tfd.split_plan(b, s, h, d, _t(pos), False, INT4)  # the device-pos grid
    qe, qo = tfd._q_halves(_t(q), h, d, split)  # bf16-rounded, as the kernel reads q
    pos_b = np.broadcast_to(pos, (b,))
    got = torch.stack([
        _chunked_q4(qe[i], qo[i], *_split(rows[i], scale[i], h), _t(bias[i]), int(pos_b[i]) + 1,
                    plan.chunk, plan.n_chunks, split)
        for i in range(b)]).numpy()
    tbias = _t(bias) if with_bias else None
    plain = tfd.flash_decode_attention_q4_ref(_t(q), rows, scale, _t(pos), tbias, n_head=h,
                                              head_dim=d, split=split)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)
    pallas = jfd.flash_decode_attention2_q4(
        jnp.asarray(q), jax_rows[0][0], jax_rows[1][0], jnp.asarray(pos),
        jnp.asarray(bias) if with_bias else None, n_head=h, head_dim=d, block=64,
        interpret=True, split=split)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-2, rtol=0)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("pos_kind", POS_KINDS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_q4_chunked_softmax_matches_stacked_plain_version_and_pallas(split, d, pos_kind,
                                                                     with_bias):
    """The stacked kernel attends over rows [0, pos) of the layer's slab and
    the in-flight row, which takes no bias: one row more than the flat call
    at the same pos."""
    b, s, h, n_layer, layer = 3, 320, 2, 2, 1
    chunk = tfd.CHUNK_ROWS[INT4][d]
    q, jax_rows, jax_new, (stack, sc, new_c, new_s) = _inputs(
        2 * d + len(pos_kind) + with_bias, b, s, h, d, split, n_layer)
    pos = np.clip(_positions(pos_kind, chunk, s, b) + 1, 1, s - 1)  # rows [0, pos] in all
    bias = _caption_bias(pos, b, s, chunk, with_bias)
    plan = tfd.split_plan(b, s, h, d, _t(pos), True, INT4)
    qe, qo = tfd._q_halves(_t(q), h, d, split)
    pos_b = np.broadcast_to(pos, (b,))
    got = []
    for i in range(b):
        p = int(pos_b[i])
        rows = torch.cat([stack[layer, i, :p], new_c[i:i + 1]])
        scale = torch.cat([sc[layer, i, :p], new_s[i:i + 1]])
        brow = torch.cat([_t(bias[i, :p]), torch.zeros(1)])
        got.append(_chunked_q4(qe[i], qo[i], *_split(rows, scale, h), brow, p + 1, plan.chunk,
                               plan.n_chunks, split))
    got = torch.stack(got).numpy()
    tbias = _t(bias) if with_bias else None
    plain = tfds.flash_stacked_q4(_t(q), new_c, new_s, stack, sc, layer, _t(pos), tbias,
                                  n_head=h, head_dim=d, split=split)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)
    pallas = jfds.flash_stacked_q4(
        jnp.asarray(q), jax_new[0], jdec._pad_scales(jax_new[1], h), jax_rows[0],
        jdec._pad_scales(jax_rows[1], h), jnp.asarray(layer), jnp.asarray(pos),
        jnp.asarray(bias) if with_bias else None, n_head=h, head_dim=d, block=64,
        interpret=True, split=split)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-2, rtol=0)
