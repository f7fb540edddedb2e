"""The split design of the chunk attention kernels (csrc/flash_chunk.cuh:
B7 `flash_chunk_attention` and `_q8`, B8 `flash_chunk_attention_q4`) on
the CPU: its launch plan, and its arithmetic written out here in torch.

- `chunk_plan`: the chunk length is one constant, the kernels' (never a
  function of the slab, D, B, K or pos); the tiles hold every query, and
  the grid, workspace and counters cover every live chunk of every tile,
  the whole cache for a position tensor.
- `_split_tile` does what a work item and the merge do, for one batch row
  and one tile of queries: per chunk of `CHUNK_ROWS` rows an fp32
  online softmax in log2 units over 8-row stages, whose running max moves
  only when a score passes it by 2^8 (one vote for the tile's queries of a
  head), giving (m, l, acc) per query; then the parts merged in chunk order
  with weights exp2(m_c - max m), parts that saw no row weighing 0.
  Against the port's plain versions (bf16, int8, int4 split and
  interleaved; D 64/100/128; K 1, 4, 8 and the 120-query prefill chunk) at
  positions on each side of a chunk boundary, per-row positions whose last
  query is one past the cache, a left-padded caption bias that masks a
  whole chunk for some queries of a tile and the diagonal exception on a
  chunk boundary: fp32 against fp32 in another order of sums, atol 1e-5.
  Against the JAX package's Pallas kernels in interpret mode at the
  in-cache positions, atol 1e-2, as `tests/test_torch_spec_kernels.py`
  holds the plain versions to them (the Pallas kernels round p and alpha
  to bf16).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import quant as jquant
from controlar_tpu.ops import flash_chunk as jfc
from controlar_tpu_torch.ops import flash_chunk as tfc
from controlar_tpu_torch.ops.w4_matmul import unpack_nibbles

HEAD_DIMS = (64, 100, 128)
KINDS = ("bf16", "int8", "int4_split", "int4_interleaved")
PALLAS_ATOL = 1e-2
LOG2E = 1.0 / math.log(2.0)
SLACK = 8.0  # log2 units


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the launch plan ------------------------------------------------------

def test_chunk_rows_is_the_kernels_constant():
    src = (Path(tfc.__file__).parents[1] / "csrc" / "flash_chunk.cuh").read_text()
    assert re.findall(r"constexpr int kChunk = (\d+);", src) == [str(tfc.CHUNK_ROWS)]
    assert tfc.CHUNK_ROWS % 8 == 0  # whole 8-row stages


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_chunk_partition_depends_on_the_visible_rows_only(d):
    """Never on B, K or H beyond the rows the last query sees, so a row's
    output does not depend on the batch it is in."""
    s = 768
    for b in (1, 2, 16, 64):
        for k in (1, 2, 3, 4, 8, 120, 256):
            for pos in (0, 1, 31, 32, 33, 63, 64, 65, 255, 572, s - 1, s + 3,
                        torch.zeros(b, dtype=torch.int32)):
                rows = s if isinstance(pos, torch.Tensor) else min(pos + k, s)
                plan = tfc.chunk_plan(b, s, 12, d, k, pos)
                assert plan.n_chunks == max(1, math.ceil(rows / tfc.CHUNK_ROWS))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 120])
def test_chunk_plan_covers_every_live_chunk(d, k):
    b, s, h = 16, 300, 5
    chunk = tfc.CHUNK_ROWS
    full = tfc.chunk_plan(b, s, h, d, k, torch.zeros(b, dtype=torch.int32))
    assert full.nq == tfc.chunk_tile(k) and full.nq in (2, 4, 8)
    assert full.n_tiles * full.nq >= k > (full.n_tiles - 1) * full.nq  # every query, no empty tile
    # a position tensor: every row of the cache
    assert full.n_chunks * chunk >= s > (full.n_chunks - 1) * chunk
    tiles = b * h * full.n_tiles
    assert full.counters == tiles
    assert full.ws_floats == tiles * full.n_chunks * full.nq * (d + 4)
    for pos in range(-k - 2, s + 3):
        plan = tfc.chunk_plan(b, s, h, d, k, pos)
        live = min(max(pos + k, 0), s)  # the rows the last query sees
        assert plan.n_chunks == max(1, math.ceil(live / chunk))
        assert plan[:2] == full[:2] and plan.counters == full.counters
        assert plan.n_chunks <= full.n_chunks and plan.ws_floats <= full.ws_floats
        assert plan.ws_floats == tiles * plan.n_chunks * plan.nq * (d + 4)


# ---- the kernel's arithmetic ------------------------------------------------

def _split_tile(q, k, v, ks, vs, bias, pos, q0, nq, chunk, n_chunks, s):
    """One batch row's tile of queries q0 .. q0 + nq - 1 as the kernel does
    it. q (K, H, D) fp32 (bf16-valued); k, v (S, H, D) fp32 in one order of
    the head's dims (the dot product and the output do not depend on it);
    ks, vs (S, H) the per-row scales (ones for bf16); bias (S,) or None.
    Returns (nq, H, D)."""
    _, h, d = q.shape
    scale = LOG2E / math.sqrt(d)
    n_rows = max(0, min(pos + q0 + nq, s))
    live = max(1, -(-n_rows // chunk))
    assert live <= n_chunks  # the grid holds the tile's live chunks
    own = pos + q0 + torch.arange(nq)  # each query's own row, the last it sees
    qt = q[q0:q0 + nq]
    parts = []
    for c in range(live):
        r0 = c * chunk
        rows_c = max(0, min(chunk, n_rows - r0))
        m = torch.full((nq, h), -math.inf)
        l, acc = torch.zeros(nq, h), torch.zeros(nq, h, d)
        for st in range(0, rows_c, 8):
            r = torch.arange(r0 + st, r0 + min(st + 8, rows_c))  # absolute rows
            x = torch.einsum("jhd,rhd->jhr", qt, k[r]) * (ks[r].T[None] * scale)
            if bias is not None:
                x = x + torch.where(r[None, :] == own[:, None], 0.0,
                                    bias[r][None, :] * LOG2E)[:, None, :]
            x = torch.where((r[None, :] <= own[:, None])[:, None, :], x, -math.inf)
            vote = (x > (m + SLACK)[..., None]).any(-1).any(0)  # (H,): one warp a head
            m_new = torch.where(vote[None], torch.maximum(m, x.amax(-1)), m)
            alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
            p = torch.where(x == -math.inf, 0.0, torch.exp2(x - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("jhr,rhd->jhd", p * vs[r].T[None], v[r])
            m = m_new
        parts.append((m, l, acc))  # m = -inf, l = 0: a query that saw no row
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = torch.zeros(nq, h, d), torch.zeros(nq, h)
    for m, l, acc in parts:  # chunk order
        w = torch.where(m == -math.inf, 0.0, torch.exp2(m - mx))
        num = num + w[..., None] * acc
        den = den + w * l
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)


def _slab(kind, kv, h, d):
    """The slab each kind's kernel reads, made by the JAX package's
    quantizers: (port tensors for the plain version, JAX arrays for the
    Pallas kernel, the fp32 k, v (B, S, H, D) in the transcription's dim
    order, ks, vs (B, S, H))."""
    b, s, _ = kv.shape
    if kind == "bf16":
        kvb = jnp.asarray(kv, jnp.bfloat16)
        f = _t(np.asarray(kvb.astype(jnp.float32))).reshape(b, s, 2, h, d)
        ones = torch.ones(b, s, h)
        return (_t(np.asarray(kvb.astype(jnp.float32))).bfloat16(),), (kvb,), f[:, :, 0], \
            f[:, :, 1], ones, ones
    if kind == "int8":
        rows, sc = jquant.quantize_kv_rows(jnp.asarray(kv), h)
        f = _t(np.asarray(rows)).float().reshape(b, s, 2, h, d)
        sct = _t(np.asarray(sc))
        return (_t(np.asarray(rows)), sct), (rows, sc), f[:, :, 0], f[:, :, 1], \
            sct[..., :h].float(), sct[..., h:2 * h].float()
    split = kind == "int4_split"
    carriers, sc = jquant.quantize_kv_rows_4(jnp.asarray(kv), h, split=split)
    half = h * d // 2
    rows = _t(np.asarray(carriers).reshape(b, s, 2, -1)[..., :half].reshape(b, s, -1))
    lo, hi = (x.float() for x in unpack_nibbles(rows.reshape(b, s, 2, h, d // 2)))
    f = torch.cat([lo, hi], -1)  # pair order: (even | odd) of each head
    sct = _t(np.asarray(sc))
    return (rows, sct), (carriers, sc), f[:, :, 0], f[:, :, 1], sct[..., :h].float(), \
        sct[..., h:2 * h].float()


def _q_pairs(kind, q, h, d):
    """q (B, K, H*D) -> bf16-valued fp32 (B, K, H, D), int4 in pair order."""
    qh = q.to(torch.bfloat16).float().reshape(*q.shape[:2], h, d)
    if kind == "int4_interleaved":
        return torch.cat([qh[..., 0::2], qh[..., 1::2]], -1)
    return qh  # split-rope q is already (even | odd)


def _to_layout(kind, out):
    """(…, D) in the transcription's order -> q's layout."""
    if kind != "int4_interleaved":
        return out
    d = out.shape[-1]
    return torch.stack([out[..., :d // 2], out[..., d // 2:]], -1).reshape(out.shape)


def _plain(kind, q, port, pos, bias, h, d):
    if kind == "bf16":
        return tfc.flash_chunk_attention_ref(q, *port, pos, bias, n_head=h)
    if kind == "int8":
        return tfc.flash_chunk_attention_q8_ref(q, *port, pos, bias, n_head=h)
    return tfc.flash_chunk_attention_q4_ref(q, *port, pos, bias, n_head=h, head_dim=d,
                                            split=kind == "int4_split")


def _pallas(kind, q, jax_slab, pos, bias, h, d):
    jb = None if bias is None else jnp.asarray(bias.numpy())
    jq, jp = jnp.asarray(q.numpy()), jnp.asarray(pos.numpy())
    if kind == "bf16":
        out = jfc.flash_chunk_attention(jq, *jax_slab, jp, jb, n_head=h, block=64, interpret=True)
    elif kind == "int8":
        out = jfc.flash_chunk_attention_q8(jq, *jax_slab, jp, jb, n_head=h, block=64,
                                           interpret=True)
    else:
        out = jfc.flash_chunk_attention_q4(jq, *jax_slab, jp, jb, n_head=h, head_dim=d, block=64,
                                           interpret=True, split=kind == "int4_split")
    return np.asarray(out, np.float32)


def _cases(chunk, k, s):
    """(positions, with the caption bias, in the cache) of one case: the
    rows the last query sees (pos + K) ending one before, on and one after a
    chunk boundary, as an int and per row; per row 0, a row past the second
    boundary and a row whose last query is one past the cache; the caption
    bias over those, which masks the whole first chunk of some rows' queries
    and sits on the diagonal at a chunk boundary (_bias)."""
    at = [max(chunk - 1 - k, 0), max(chunk - k, 0), max(chunk + 1 - k, 0)]
    one = [np.asarray(x, np.int32) for x in at]
    return [(one[1], False, True), (one[0], True, True),
            (np.array(at, np.int32), False, True), (np.array(at, np.int32), True, True),
            (np.array([0, 2 * chunk + 3, s - k + 1], np.int32), True, False)]


def _bias(pos, b, s, chunk, k):
    """(B, S) left padding: row 0 the first 3 columns; row 1 its whole first
    chunk and 3 rows more; row 2 every row before the first one the tile's
    queries own at or past a chunk boundary, so that query's only unmasked
    row is its own, the first row of a chunk (the diagonal exception)."""
    bias = np.zeros((b, s), np.float32)
    pos_b = np.broadcast_to(pos, (b,))
    bias[0, :3] = -1e9
    bias[1, :chunk + 3] = -1e9
    p2 = int(pos_b[2])
    first = next((r for r in range(p2, p2 + k) if r % chunk == 0 and r > 0), p2 + k - 1)
    bias[2, :min(first, s)] = -1e9
    return bias


SPLIT_CASES = [(kind, d, k) for kind in KINDS for d in HEAD_DIMS for k in (1, 4, 8)] + \
              [(kind, 64, 120) for kind in KINDS]


@pytest.mark.parametrize("kind,d,k", SPLIT_CASES)
def test_split_arithmetic_matches_plain_version_and_pallas(kind, d, k):
    b, h = 3, 2
    chunk = tfc.CHUNK_ROWS
    s = 2 * chunk + k + 16
    rng = np.random.default_rng(d * 1000 + k + len(kind))
    q = _t((rng.standard_normal((b, k, h * d)) * 0.5).astype(np.float32))
    kv = (rng.standard_normal((b, s, 2 * h * d)) * 0.5).astype(np.float32)
    port, jax_slab, kf, vf, ks, vs = _slab(kind, kv, h, d)
    qp = _q_pairs(kind, q, h, d)
    nq = tfc.chunk_tile(k)
    for pos, with_bias, in_cache in _cases(chunk, k, s):
        bias = _t(_bias(pos, b, s, chunk, k)) if with_bias else None
        pos_t = _t(pos)
        plan = tfc.chunk_plan(b, s, h, d, k, pos_t if pos.ndim else int(pos))
        assert plan.nq == nq and plan.n_tiles == -(-k // nq)
        pos_b = np.broadcast_to(pos, (b,))
        got = torch.zeros(b, k, h, d)
        for i in range(b):
            for q0 in range(0, k, nq):
                tile = _split_tile(qp[i], kf[i], vf[i], ks[i], vs[i],
                                   None if bias is None else bias[i], int(pos_b[i]), q0,
                                   min(nq, k - q0), chunk, plan.n_chunks, s)
                got[i, q0:q0 + nq] = tile
        got = _to_layout(kind, got).reshape(b, k, h * d)
        plain = _plain(kind, q, port, pos_t, bias, h, d)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"pos={pos} bias={with_bias}")
        if in_cache and pos.ndim and with_bias:  # one Pallas call a case: its compile dominates
            want = _pallas(kind, q, jax_slab, pos_t, bias, h, d)
            np.testing.assert_allclose(got.numpy(), want, atol=PALLAS_ATOL, rtol=0)


def test_a_query_that_sees_only_its_own_row_past_a_masked_chunk():
    """The diagonal exception on a chunk boundary: the first chunk wholly
    masked by the bias, the query's own row the first of the next chunk, so
    its output is that row's v exactly (its part weighs 1, the masked
    chunk's exp2(-1.4e9) = 0)."""
    b, h, d, k = 1, 2, 64, 4
    chunk = tfc.CHUNK_ROWS
    s = 2 * chunk
    rng = np.random.default_rng(5)
    q = _t((rng.standard_normal((b, k, h * d)) * 0.5).astype(np.float32))
    kv = (rng.standard_normal((b, s, 2 * h * d)) * 0.5).astype(np.float32)
    port, _, kf, vf, ks, vs = _slab("bf16", kv, h, d)
    pos = chunk - 2  # query 2 owns row `chunk`
    bias = torch.zeros(b, s)
    bias[0, :chunk + 1] = -1e9
    got = _split_tile(_q_pairs("bf16", q, h, d)[0], kf[0], vf[0], ks[0], vs[0], bias[0], pos, 0,
                      k, chunk, 2, s)
    torch.testing.assert_close(got[2], vf[0, chunk], rtol=0, atol=0)
    plain = tfc.flash_chunk_attention_ref(q, *port, pos, bias, n_head=h).reshape(k, h, d)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
