"""The stacked cache's writes of a decode step (`ops.cache_append`) against
the old write sequence and the JAX package (CPU).

- The step's writes, as the stacked branch of `decode._decode_layers` makes
  them (each layer's k / v rows into the step's in-flight rows with
  `append_kv` at row 0 of layer l, then one `append_stacked`), bit for bit
  against the sequence they replace (per layer cat, the port's quantizer
  and a contiguous copy per stream; per stream a stack of the layers' rows
  and an indexed assignment or `cache_append_rows_stacked`): bf16, f32,
  int8, int4 split and interleaved caches, k / v as the strided views the
  projections leave, an int position (`generate`) and per-slot positions
  that include 1 and S - 1 (the serving step after the pos >= 1 clamp).
- `append_stacked` on every stream against the JAX package's Pallas
  `cache_append_rows_stacked` (interpret mode), bit for bit on the port's
  unpadded widths.
- The plain version refuses a position outside the cache, as the old
  sequence did (the kernel skips that row); the wrapper's checks raise
  ValueError; the in-flight rows of a layer are contiguous and start at a
  multiple of 16 bytes.
- The per-slot stacked step raises a slot at position 0 to 1 before it
  writes, as the JAX package does.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu.ops import cache_append as jca
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.ops import cache_append as tca

L, B, S = 3, 4, 40
PER_SLOT = [1, S - 1, 7, 22]

# cache kind: (cache dtype for init, kv heads, head dim, split int4 carriers)
KINDS = {
    "bf16": (torch.bfloat16, 2, 16, False),
    "f32": (torch.float32, 2, 16, False),
    "int8": (torch.int8, 2, 16, False),
    "int4_split": ("int4", 2, 10, True),
    "int4_pairs": ("int4", 3, 16, False),
}


def _cfg(kind):
    dtype, kvh, d, _ = KINDS[kind]
    return GPTConfig(model_type="c2i", dim=kvh * d, n_layer=L, n_head=kvh, vocab_size=16,
                     num_classes=4, block_size=16), dtype


def _case(kind, seed):
    """A stacked cache of `kind` with random contents and one step's new
    rows of every layer: k, v (B, 1, KV*D) views into a projection's output
    (v a slice of a wqkv row, k a slice of a rotated [q|k] row)."""
    cfg, dtype = _cfg(kind)
    _, kvh, d, split = KINDS[kind]
    kvd = kvh * d
    g = torch.Generator().manual_seed(seed)
    cache = tdec.init_stacked_caches(cfg, B, S, dtype)
    for x in tca.stream_list(cache):
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-128, 128, x.shape, generator=g, dtype=torch.int8))
        else:
            x.copy_(torch.rand(x.shape, generator=g) * 0.02 if x is not cache else
                    torch.randn(x.shape, generator=g))
    new = []
    for _ in range(L):
        qkv = (torch.randn(B, 1, 3 * kvd, generator=g) * 2).to(torch.bfloat16)
        qk = (torch.randn(B, 1, 2 * kvd, generator=g) * 2).to(torch.bfloat16)
        new.append((qk[..., kvd:], qkv[..., 2 * kvd:]))
    new[0][0][0, 0, :d] = 0  # a head of zeros: the scale's floor
    return cache, new, kvh, split


def _fused(cache, new, pos, kvh, split):
    inflight = tca.stacked_inflight(cache, B)
    for l, (k, v) in enumerate(new):
        tca.append_kv(tca.inflight_layer(inflight, l), k, v, 0, kv_heads=kvh, split=split)
    return tca.append_stacked(cache, inflight, pos)


def _old(cache, new, pos, kvh, split):
    inflight = []
    for k, v in new:
        kv_rows = torch.cat([k[:, 0], v[:, 0]], dim=-1)
        inflight.append([src.to(dst.dtype).contiguous()
                         for dst, src in tca.cache_streams(cache, kv_rows, kvh, split)])
    for i, dst in enumerate(tca.stream_list(cache)):
        rows = torch.stack([r[i] for r in inflight])
        if isinstance(pos, int):
            dst[:, :, pos] = rows
        else:
            tca.cache_append_rows_stacked(dst, rows, pos)
    return cache


def _t(a):
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()} if isinstance(cache, dict) else cache.clone()


def _bits(x):
    return x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("pos", ["int", "per_slot"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_step_writes_equal_the_old_sequence(kind, pos):
    cache, new, kvh, split = _case(kind, seed=len(kind))
    p = S - 1 if pos == "int" else torch.tensor(PER_SLOT, dtype=torch.int32)
    got = _fused(_clone(cache), new, p, kvh, split)
    want = _old(_clone(cache), new, p, kvh, split)
    for a, b in zip(tca.stream_list(got), tca.stream_list(want)):
        assert torch.equal(_bits(a), _bits(b))
    changed = sum(int((_bits(a) != _bits(c)).any()) for a, c in
                  zip(tca.stream_list(got), tca.stream_list(cache)))
    assert changed == len(tca.stream_list(cache))  # every stream was written


# the Pallas kernel rewrites the aligned 8- or 32-row window around a
# position: its cache rows are a multiple of 32
S_PALLAS = 64
# stream: (JAX dtype, width in the JAX cache, width in the port's)
STREAMS = {
    "f32_rows": (jnp.float32, 256, 256),
    "bf16_rows": (jnp.bfloat16, 256, 256),
    "int8_rows": (jnp.int8, 256, 256),
    "f32_scales": (jnp.float32, 128, 6),  # JAX pads 2H to 128 lanes
}


@pytest.mark.parametrize("pos", ["int", "per_slot"])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_append_stacked_matches_pallas_bit_for_bit(stream, pos):
    jdt, wj, wt = STREAMS[stream]
    rng = np.random.default_rng(len(stream))
    s = S_PALLAS
    positions = np.array([1, s - 1, 31, 32] if pos == "per_slot" else [s - 1] * B, np.int32)
    if jdt == jnp.int8:
        cache = rng.integers(-127, 128, (L, B, s, wj)).astype(np.int8)
        rows = rng.integers(-127, 128, (L, B, wj)).astype(np.int8)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal((L, B, s, wj)), jdt))
        rows = np.asarray(jnp.asarray(rng.standard_normal((L, B, wj)) * 3, jdt))
    want = np.asarray(jca.cache_append_rows_stacked(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(positions), interpret=True))

    got = _t(cache)[..., :wt].contiguous()
    inflight = tca.stacked_inflight(got, B)
    inflight.copy_(_t(rows)[..., :wt])
    p = s - 1 if pos == "int" else torch.from_numpy(positions)
    before = tca.append_stacked.launches
    assert tca.append_stacked(got, inflight, p) is got
    assert tca.append_stacked.launches == before  # the plain version counts no launch
    bits = torch.int16 if jdt == jnp.bfloat16 else torch.uint8
    np.testing.assert_array_equal(
        got.view(bits).numpy(),
        _t(want)[..., :wt].contiguous().view(bits).numpy())


@pytest.mark.parametrize("pos", [[0, S, 2, 3], [-1, 0, 1, 2], S])
def test_append_stacked_refuses_a_position_outside_the_cache(pos):
    """The plain version raises where the old sequence raised (the kernel
    skips the row), and leaves the cache as it was."""
    cache, new, kvh, split = _case("int8", seed=1)
    p = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
    before = _clone(cache)
    with pytest.raises(IndexError):
        _old(_clone(cache), new, p, kvh, split)
    with pytest.raises(IndexError):
        _fused(cache, new, p, kvh, split)
    if not isinstance(pos, int):
        for a, b in zip(tca.stream_list(cache), tca.stream_list(before)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_inflight_layers_are_aligned_and_contiguous(kind):
    cfg, dtype = _cfg(kind)
    cache = tdec.init_stacked_caches(cfg, 3, S, dtype)
    inflight = tca.stacked_inflight(cache, 3)
    for x, rows in zip(tca.stream_list(cache), tca.stream_list(inflight)):
        assert rows.shape == (L, 3, x.shape[-1]) and rows.dtype == x.dtype
        for l in range(L):
            assert rows[l].is_contiguous() and rows[l].data_ptr() % 16 == 0
        layer = tca.inflight_layer(inflight, 1)
        view = layer if not isinstance(layer, dict) else tca.stream_list(layer)[0]
        assert view.shape[:2] == (3, 1) and view.is_contiguous()


def _bad(name):
    cache, new, kvh, split = _case("int8", seed=2)
    inflight = tca.stacked_inflight(cache, B)
    pos = torch.tensor(PER_SLOT, dtype=torch.int32)
    if name == "missing_stream":
        inflight = {"kv": inflight["kv"]}
    elif name == "wrong_dtype":
        inflight = dict(inflight, s=inflight["s"].double())
    elif name == "wrong_batch":
        inflight = tca.stacked_inflight(cache, B - 1)
    elif name == "strided_rows":
        inflight = dict(inflight, kv=inflight["kv"].transpose(0, 1).contiguous().transpose(0, 1))
    elif name == "pos_dtype":
        pos = pos.long()
    elif name == "pos_shape":
        pos = pos[:2]
    elif name == "float_pos":
        pos = 3.0
    elif name == "flat_cache":
        cache = {k: v[0] for k, v in cache.items()}
    return cache, inflight, pos


@pytest.mark.parametrize("name", ["missing_stream", "wrong_dtype", "wrong_batch", "strided_rows",
                                  "pos_dtype", "pos_shape", "float_pos", "flat_cache"])
def test_append_stacked_rejects(name):
    with pytest.raises(ValueError):
        tca.append_stacked(*_bad(name))


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.int8, "int4"])
def test_per_slot_step_raises_position_0_to_1(cache):
    """A never-admitted slot at position 0 takes its row at position 1 of
    every layer (the JAX package's pos >= 1 clamp); row 0 stays as it was."""
    cfg = GPTConfig(model_type="c2i", dim=64, n_layer=2, n_head=2, vocab_size=32,
                    num_classes=4, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0)
    caches = tdec.init_stacked_caches(cfg, 2, 16, cache)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    with torch.no_grad():
        tdec.decode_step_multi(model, cfg, caches, torch.tensor([1, 2]), pos, use_flash=True)
    for x in tca.stream_list(caches):
        assert x[:, 0, 0].abs().sum() == 0
        assert x[:, 0, 1].abs().sum() > 0 and x[:, 1, 5].abs().sum() > 0
        assert x[:, 1, :5].abs().sum() == 0 and x[:, 0, 2:].abs().sum() == 0
