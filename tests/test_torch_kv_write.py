"""The fused KV-cache write (`ops.cache_append.append_kv`) against the JAX
package (CPU).

- its plain path, bit for bit, against the JAX package's quantizer
  (`decode._quantize_rows_for`) followed by the Pallas row or block append of
  each stream, run in interpret mode by a patched pallas_call: bf16, f32,
  int8, int4 split and int4 interleaved caches, T 1 and 4, D 64 and 100, k
  and v in bf16 and f32 as the strided views that `_qkv` and `_qkv_for` make
  them, per-row positions that include 0 and S - T, and one Python-int
  position for every row (the flat step). Every row of the cache is
  compared, on the port's unpadded widths;
- the wrapper's checks: bad shapes, dtypes and devices raise ValueError;
- every per-layer decode path writes a layer's new rows with one
  `append_kv` call; a stacked step writes each layer's rows into the step's
  in-flight rows with one `append_kv` call and the stack with one
  `append_stacked`.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.ops import cache_append as jca
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch import spec_decode as tspec
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.ops import cache_append as tca

B, S, H, KV = 4, 48, 3, 2
SLACK = 64  # rows past S in the JAX cache: the Pallas block append's window slack
INT_POS = 13


def _t(a):
    return torch.from_numpy(np.array(a))


def _pallas(fn, *args):
    """A JAX package kernel, run in interpret mode by a patched pallas_call
    (the package itself is unchanged)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return getattr(fn, "__wrapped__", fn)(*args)
    finally:
        pl.pallas_call = orig


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _jax_cache(kind, d, rng):
    """Random cache contents in the JAX package's padded layout, S + SLACK rows."""
    n = S + SLACK
    if kind in ("bf16", "f32"):
        dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        return jnp.asarray(rng.standard_normal((B, n, 2 * KV * d)), dt)
    scales = rng.uniform(0.002, 0.02, (B, n, jdec.scale_pad(KV))).astype(np.float32)
    if kind == "int8":
        return {"kv": jnp.asarray(rng.integers(-128, 128, (B, n, 2 * KV * d)).astype(np.int8)),
                "s": jnp.asarray(scales)}
    w = jquant.kv4_row_width(KV, d)
    return {"kv4": jnp.asarray(rng.integers(-128, 128, (B, n, 2 * w)).astype(np.int8)),
            "s": jnp.asarray(scales)}


def _port_view(jcache, kind, d):
    """The JAX cache's first S rows on the port's unpadded widths, as numpy
    arrays: {stream: array}."""
    if kind in ("bf16", "f32"):
        a = np.asarray(jcache)[:, :S]
        return {"rows": a.view(np.uint16) if kind == "bf16" else a}
    s = np.asarray(jcache["s"])[:, :S, : 2 * KV]
    if kind == "int8":
        return {"kv": np.asarray(jcache["kv"])[:, :S], "s": s}
    c = np.asarray(jcache["kv4"])[:, :S]
    half = KV * d // 2
    c = c.reshape(B, S, 2, -1)[..., :half].reshape(B, S, 2 * half)
    return {"kv4": c, "s": s}


def _port_cache(view, kind):
    if kind == "bf16":
        return _t(view["rows"].view(np.int16)).view(torch.bfloat16)
    if kind == "f32":
        return _t(view["rows"])
    return {key: _t(a) for key, a in view.items()}


def _port_bits(cache):
    if isinstance(cache, dict):
        return {key: _bits(t.numpy()) for key, t in cache.items()}
    if cache.dtype == torch.bfloat16:
        return {"rows": cache.view(torch.int16).numpy().view(np.uint16)}
    return {"rows": _bits(cache.numpy())}


def _kv_views(k, v, layout, dtype):
    """k, v (B, T, KV*D) as the port's projections leave them: `_qkv` (k the
    rotated copy, v a slice of the wqkv output) or `_qkv_for` in split
    layout (k a slice of the rotated [q|k], v a slice of the wqkv output)."""
    b, t, kvd = k.shape
    d = kvd // KV
    qkv = torch.zeros(b, t, (H + 2 * KV) * d)
    qkv[..., (H + KV) * d:] = torch.from_numpy(v)
    v_view = qkv.to(dtype)[..., (H + KV) * d:]
    if layout == "qkv":
        return torch.from_numpy(k).to(dtype), v_view
    qk = torch.ones(b, t, (H + KV) * d)
    qk[..., H * d:] = torch.from_numpy(k)
    return qk.to(dtype)[..., H * d:], v_view


CASES = [(kind, t, d, layout, pos, dtype)
         for kind in ("bf16", "f32", "int8", "int4_split", "int4")
         for t in (1, 4) for d in (64, 100)
         for layout, pos in (("qkv", "rows"), ("qkv_split", "rows"), ("qkv", "int"))
         for dtype in ("bf16", "f32")]


@pytest.mark.parametrize("kind,t,d,layout,pos,dtype", CASES)
def test_append_kv_matches_jax_bit_for_bit(kind, t, d, layout, pos, dtype):
    rng = np.random.default_rng([t, d, len(kind), len(layout), len(pos), len(dtype)])
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    # k, v rounded to the input dtype first: both packages see the same values
    k = torch.from_numpy(rng.standard_normal((B, t, KV * d)).astype(np.float32) * 2).to(tdt)
    v = torch.from_numpy(rng.standard_normal((B, t, KV * d)).astype(np.float32) * 2).to(tdt)
    k[0, 0, :d] = 0  # a head of zeros: the scale's 1e-8 floor
    v[1, -1, d:2 * d] *= 1000  # an outlier head
    k, v = k.float().numpy(), v.float().numpy()
    positions = np.array([0, S - t, 7, 33], np.int32)
    jpos = positions if pos == "rows" else np.full(B, INT_POS, np.int32)

    split = kind == "int4_split"
    jcache = _jax_cache("int4" if split else kind, d, rng)
    got = _port_cache(_port_view(jcache, "int4" if split else kind, d), kind)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kv_rows = jnp.concatenate([jnp.asarray(k, jdt), jnp.asarray(v, jdt)], axis=-1)
    append = jca.cache_append_rows if t == 1 else jca.cache_append_block

    def jax_append(cache, rows):
        return _pallas(append, cache, rows[:, 0] if t == 1 else rows, jnp.asarray(jpos))

    if isinstance(jcache, dict):
        key = "kv4" if "kv4" in jcache else "kv"
        q_rows, s_rows = jdec._quantize_rows_for(jcache, kv_rows, KV, split=split)
        want = {key: jax_append(jcache[key], q_rows), "s": jax_append(jcache["s"], s_rows)}
    else:
        want = jax_append(jcache, kv_rows.astype(jcache.dtype))
    want = _port_view(want, "int4" if split else kind, d)

    kt, vt = _kv_views(k, v, layout, tdt)
    assert vt.stride(-1) == 1 and not vt.is_contiguous()
    before = tca.append_kv.launches
    out = tca.append_kv(got, kt, vt, _t(positions) if pos == "rows" else INT_POS,
                        kv_heads=KV, split=split)
    assert out is got and tca.append_kv.launches == before  # plain path on the CPU
    got_bits = _port_bits(got)
    for stream, a in want.items():
        np.testing.assert_array_equal(got_bits[stream], _bits(a), err_msg=stream)


def _good(kind="int8", t=1):
    d = 64
    cache = tdec.init_flat_caches(GPTConfig(dim=H * d, n_layer=1, n_head=H, n_kv_head=KV),
                                  B, S, {"bf16": torch.bfloat16, "int8": torch.int8,
                                         "int4": "int4"}[kind])[0]
    k = torch.randn(B, t, KV * d).bfloat16()
    v = torch.randn(B, t, KV * d).bfloat16()
    return cache, k, v, torch.tensor([0, 1, 2, 3], dtype=torch.int32)


def _bad(case):
    cache, k, v, pos = _good()
    kw = dict(kv_heads=KV)
    if case == "k_rank":
        k = k[:, 0]
    elif case == "v_shape":
        v = v[..., :64]
    elif case == "k_dtype":
        k = k.to(torch.int32)
    elif case == "kv_dtypes_differ":
        v = v.float()
    elif case == "last_dim_strided":
        k = torch.randn(B, 1, 2 * KV * 64).bfloat16()[..., ::2]
    elif case == "kv_heads":
        kw["kv_heads"] = 3
    elif case == "odd_head_dim":
        k, v = k[..., :126], v[..., :126]
        kw["kv_heads"] = 2
    elif case == "head_dim_over_256":
        k, v = torch.randn(B, 1, 2 * 512).bfloat16(), torch.randn(B, 1, 2 * 512).bfloat16()
    elif case == "cache_width":
        cache = {"kv": cache["kv"][..., :-2].contiguous(), "s": cache["s"]}
    elif case == "cache_batch":
        cache = {"kv": cache["kv"][:2], "s": cache["s"][:2]}
    elif case == "scales_shape":
        cache = {"kv": cache["kv"], "s": cache["s"][..., :-1].contiguous()}
    elif case == "scales_dtype":
        cache = {"kv": cache["kv"], "s": cache["s"].bfloat16()}
    elif case == "cache_keys":
        cache = {"kv": cache["kv"], "scales": cache["s"]}
    elif case == "cache_dtype":
        cache = torch.zeros(B, S, 2 * KV * 64, dtype=torch.int16)
    elif case == "cache_noncontig":
        cache = {"kv": torch.zeros(B, 2 * S, 2 * KV * 64, dtype=torch.int8)[:, ::2],
                 "s": cache["s"]}
    elif case == "pos_dtype":
        pos = pos.long()
    elif case == "pos_shape":
        pos = pos[:2]
    elif case == "pos_float":
        pos = 3.0
    elif case == "pos_bool":
        pos = True
    elif case == "k_device":
        k = k.to("meta")
    elif case == "pos_device":
        pos = pos.to("meta")
    elif case == "cache_device":
        cache = {key: t.to("meta") for key, t in cache.items()}
        k, v, pos = k.to("meta"), v.to("meta"), pos.to("meta")
    return cache, k, v, pos, kw


BAD = ["k_rank", "v_shape", "k_dtype", "kv_dtypes_differ", "last_dim_strided", "kv_heads",
       "odd_head_dim", "head_dim_over_256", "cache_width", "cache_batch", "scales_shape",
       "scales_dtype", "cache_keys", "cache_dtype", "cache_noncontig", "pos_dtype", "pos_shape",
       "pos_float", "pos_bool", "k_device", "pos_device", "cache_device"]


@pytest.mark.parametrize("case", BAD)
def test_append_kv_rejects(case):
    cache, k, v, pos, kw = _bad(case)
    with pytest.raises(ValueError):
        tca.append_kv(cache, k, v, pos, **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_append_kv_good_operands_pass_the_checks(kind):
    cache, k, v, pos = _good(kind, t=4)
    tca.append_kv(cache, k, v, pos, kv_heads=KV)
    tca.append_kv(cache, k, v, 40, kv_heads=KV)


@functools.lru_cache(maxsize=None)
def _tiny_model():
    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=4, vocab_size=64,
                    num_classes=10, block_size=16)
    return cfg, tgpt.init_gpt(cfg, seed=0)


@pytest.mark.parametrize("path", ["flat", "multi", "chunk", "flat_stacked", "multi_stacked"])
@pytest.mark.parametrize("cache", [torch.float32, torch.int8, "int4"])
def test_each_decode_path_writes_a_layer_once(monkeypatch, path, cache):
    cfg, model = _tiny_model()
    calls = []

    def counting(c, k, v, pos, **kw):
        calls.append((id(c), k.shape, pos))
        return tca.append_kv(c, k, v, pos, **kw)

    monkeypatch.setattr(tdec, "append_kv", counting)
    ends = []

    def counting_end(c, inflight, pos):
        ends.append(pos)
        return tca.append_stacked(c, inflight, pos)

    monkeypatch.setattr(tdec, "append_stacked", counting_end)
    b, s = 2, 24
    stacked = path.endswith("stacked")
    init = tdec.init_stacked_caches if stacked else tdec.init_flat_caches
    caches = init(cfg, b, s, cache)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    kw = dict(fused3=None, use_flash=False)
    with torch.no_grad():
        if path.startswith("flat"):
            tdec.decode_step_flat(model, cfg, caches, torch.tensor([1, 2]), 4, col_mask_full=None,
                                  **kw)
        elif path.startswith("multi"):
            tdec.decode_step_multi(model, cfg, caches, torch.tensor([1, 2]), pos, **kw)
        else:
            tspec.forward_chunk(model, cfg, caches, torch.tensor([[1, 2, 3], [4, 5, 6]]), pos,
                                **kw)
    t = 3 if path == "chunk" else 1
    assert all(c[1] == (b, t, cfg.kv_heads * cfg.head_dim) for c in calls)
    if stacked:  # a layer's rows into the step's in-flight rows, then one write a step
        assert len(calls) == cfg.n_layer and all(c[2] == 0 for c in calls)
        assert len(ends) == 1 and (ends[0] == 4 if path == "flat_stacked"
                                   else torch.equal(ends[0], pos))
        return
    assert ends == []
    assert [c[0] for c in calls] == [id(c) for c in caches]
    assert all((c[2] == 4) if path == "flat" else torch.equal(c[2], pos) for c in calls)
