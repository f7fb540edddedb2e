"""The serving slice's per-slot primitives against the JAX package's (CPU).

- `cache_append_rows` (plain version; the CUDA kernel's counterpart) against
  the Pallas kernel run in interpret mode, bit for bit;
- `decode.decode_step_multi` against the JAX package's on the same weights,
  cache contents and per-slot positions, including a never-admitted slot at
  position 0 and a frozen slot at the last position, whose control rows fall
  outside the block and are clamped;
- the keyed sampler: counter-based uniforms that depend only on (seed,
  token index, vocab index).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.config import GPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.ops import cache_append as jca
from controlar_tpu_torch import convert
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.ops import cache_append as tca
from controlar_tpu_torch.ops import sampling as tsamp


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- B6: the per-slot row append ------------------------------------------

S_APPEND = 64
POSITIONS = np.array([0, 7, 8, 31, 32, S_APPEND - 1], np.int32)


def _pallas_append(cache, rows, pos):
    """The JAX package's kernel, run in interpret mode by a patched
    pallas_call (the package itself is unchanged)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        fn = getattr(jca.cache_append_rows, "__wrapped__", jca.cache_append_rows)
        return np.asarray(fn(cache, rows, pos))
    finally:
        pl.pallas_call = orig


# stream: (JAX dtype, the port's, width in the JAX cache, width in the port's)
STREAMS = {
    "bf16_rows": (jnp.bfloat16, torch.bfloat16, 256, 256),   # RMW window 8
    "int8_rows": (jnp.int8, torch.int8, 256, 256),           # window 32
    "f32_scales": (jnp.float32, torch.float32, 128, 6),      # JAX pads 2H to 128 lanes
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_cache_append_matches_pallas_bit_for_bit(stream):
    jdt, tdt, wj, wt = STREAMS[stream]
    rng = np.random.default_rng(len(stream))
    b = len(POSITIONS)
    if jdt == jnp.int8:
        cache = rng.integers(-127, 128, (b, S_APPEND, wj)).astype(np.int8)
        rows = rng.integers(-127, 128, (b, wj)).astype(np.int8)
    else:
        cache = np.asarray(jnp.asarray(rng.standard_normal((b, S_APPEND, wj)), jdt))
        rows = np.asarray(jnp.asarray(rng.standard_normal((b, wj)) * 3, jdt))
    want = _pallas_append(jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(POSITIONS))
    # the Pallas kernel changes exactly the rows at pos[b]
    expect = cache.copy()
    expect[np.arange(b), POSITIONS] = rows
    np.testing.assert_array_equal(want.view(np.uint8), expect.view(np.uint8))

    def torch_of(a):
        t = _t(a.view(np.int16)).view(torch.bfloat16) if jdt == jnp.bfloat16 else _t(a)
        return t[..., :wt].contiguous()

    got_cache = torch_of(cache)
    before = tca.cache_append_rows.launches
    out = tca.cache_append_rows(got_cache, torch_of(rows), torch.from_numpy(POSITIONS))
    assert out is got_cache and tca.cache_append_rows.launches == before  # plain path on the CPU
    np.testing.assert_array_equal(got_cache.view(torch.uint8 if tdt != torch.bfloat16
                                                 else torch.int16).numpy(),
                                  torch_of(want).view(torch.uint8 if tdt != torch.bfloat16
                                                      else torch.int16).numpy())


def test_cache_append_casts_rows_to_the_cache_dtype():
    cache = torch.zeros(2, 4, 3, dtype=torch.bfloat16)
    rows = torch.tensor([[1.0, 2.0, 3.00390625], [4.0, 5.0, 6.0]])
    tca.cache_append_rows_ref(cache, rows, torch.tensor([3, 0], dtype=torch.int32))
    assert torch.equal(cache[0, 3], rows[0].bfloat16()) and torch.equal(cache[1, 0],
                                                                        rows[1].bfloat16())
    assert cache.float().abs().sum() == rows.bfloat16().float().abs().sum()


def test_cache_append_vector_width():
    assert tca._vec_bytes(3072, 256, 1024) == 16   # GPT-B bf16 rows
    assert tca._vec_bytes(24, 0, 512) == 8         # f32 scales of 3 heads
    assert tca._vec_bytes(3200, 0, 48) == 16       # GPT-3B int4 carriers
    assert tca._vec_bytes(6, 0, 0) == 2
    assert tca._vec_bytes(16, 0, 4) == 4           # pointer alignment bounds it
    assert tca._vec_bytes(7, 0, 0) == 1


# ---- decode_step_multi ------------------------------------------------------

S_DEC = 32
STRENGTH = np.array([0.8, 1.0, 1.2, 0.5], np.float32)[:, None, None]

# weights, model type, JAX cache dtype, the port's
MULTI_CASES = {
    "c2i_fp32": ("float", "c2i", jnp.float32, torch.float32),
    "t2i_bf16_colmask": ("float", "t2i", jnp.bfloat16, torch.bfloat16),
    "c2i_w8_kv8": ("w8", "c2i", jnp.int8, torch.int8),
    "t2i_w4split_kv4": ("w4", "t2i", jnp.int4, "int4"),
}


@functools.lru_cache(maxsize=None)
def _multi_models(weights, model_type):
    kw = dict(model_type=model_type, dim=256, n_layer=3, n_head=4, vocab_size=96,
              num_classes=10, caption_dim=24, cls_token_num=1 if model_type == "c2i" else 6,
              block_size=16)
    cfg = GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)
    params["output"] = jax.random.normal(jax.random.PRNGKey(1), params["output"].shape) * 0.5
    params = jdec.unstack_layers(params)
    if weights == "w8":
        params = jquant.quantize_gpt_params(params)
    elif weights == "w4":
        params = jquant.quantize_gpt_params_w4(params, cfg=cfg)
    return cfg, params, convert.gpt_from_jax(_np_tree(params), TGPTConfig(**kw))


def _positions(cfg):
    """A slot mid-block, a deeper one, a never-admitted slot at 0 and a
    frozen slot at the last position (control row block_size, clamped)."""
    stop = cfg.cls_token_num + cfg.block_size - 1
    return np.array([cfg.cls_token_num + 3, cfg.cls_token_num + 10, 0, stop], np.int32)


def _caches(cfg, jdt, rng):
    """Random cache contents in both packages' layouts: (JAX tuple, port list)."""
    b, h, d = 4, cfg.n_head, cfg.head_dim
    hd = h * d
    jc, tc = [], []
    for _ in range(cfg.n_layer):
        if jdt in (jnp.int8, jnp.int4):
            scales = rng.uniform(0.002, 0.02, (b, S_DEC, 2 * h)).astype(np.float32)
            s_pad = np.pad(scales, [(0, 0), (0, 0), (0, jdec.scale_pad(h) - 2 * h)])
            if jdt == jnp.int8:
                rows = rng.integers(-127, 128, (b, S_DEC, 2 * hd)).astype(np.int8)
                jc.append({"kv": jnp.asarray(rows), "s": jnp.asarray(s_pad)})
                tc.append({"kv": _t(rows), "s": _t(scales)})
            else:
                carriers = rng.integers(-128, 128, (b, S_DEC, 2, hd // 2)).astype(np.int8)
                w = jquant.kv4_row_width(h, d)
                padded = np.pad(carriers, [(0, 0)] * 3 + [(0, w - hd // 2)])
                jc.append({"kv4": jnp.asarray(padded.reshape(b, S_DEC, 2 * w)),
                           "s": jnp.asarray(s_pad)})
                tc.append({"kv4": _t(carriers.reshape(b, S_DEC, hd)), "s": _t(scales)})
        else:
            slab = jnp.asarray(rng.standard_normal((b, S_DEC, 2 * hd)) * 0.5, jdt)
            jc.append(slab)
            tc.append(_t(np.asarray(slab.astype(jnp.float32))).to(
                torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32))
    return tuple(jc), tc


def _port_rows(cache, jdt, n_head, hd):
    """The JAX cache's streams cut to the port's unpadded widths: (rows,
    scales or None)."""
    if jdt == jnp.int8:
        return np.asarray(cache["kv"]), np.asarray(cache["s"])[..., : 2 * n_head]
    if jdt == jnp.int4:
        c = np.asarray(cache["kv4"])
        b, s, _ = c.shape
        return (c.reshape(b, s, 2, -1)[..., : hd // 2].reshape(b, s, -1),
                np.asarray(cache["s"])[..., : 2 * n_head])
    return np.asarray(cache.astype(jnp.float32)), None


def _dequant(cache, cfg, split):
    if isinstance(cache, dict):
        return tdec._dequant_slab(cache, cfg, torch.float32, split)
    return cache.float()


# logits against the JAX package, relative to max |logit|:
# - plain route (use_flash=False), fp32 weights: the same fp32 arithmetic,
#   sums in another order (~1e-6);
# - the kernels' plain versions (use_flash=True) round q to bf16 as the
#   kernels read it (2**-9 relative per element), ~1e-3 of the logits;
# - a quantized cache may round one new element to the neighbouring int8 or
#   int4 step when its fp32 value differs in the last bits, moving the logits
#   by up to a few 1e-3.
LOGIT_TOL = {False: 1e-4, True: 1e-2}
ROW_TOL = {False: 1e-6, True: 1e-3}  # written float rows, relative to max |row|


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_decode_step_multi_matches_jax(case, use_flash):
    weights, model_type, jdt, tdt = MULTI_CASES[case]
    cfg, params, model = _multi_models(weights, model_type)
    tcfg = TGPTConfig(**{f: getattr(cfg, f) for f in ("model_type", "dim", "n_layer", "n_head",
                                                      "vocab_size", "num_classes", "caption_dim",
                                                      "cls_token_num", "block_size")})
    rng = np.random.default_rng(3)
    b = 4
    split = weights == "w4"
    jcaches, tcaches = _caches(cfg, jdt, rng)
    before = [_dequant(c, tcfg, split).clone() for c in tcaches]
    pos = _positions(cfg)
    token = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    fused3 = (rng.standard_normal((3, b, cfg.block_size, cfg.dim)) * 0.5).astype(np.float32)
    col = np.ones((b, S_DEC), bool)
    if model_type == "t2i":  # left padding; the never-admitted slot keeps all columns
        col[:, : cfg.cls_token_num] = (np.arange(cfg.cls_token_num)[None, :]
                                       >= np.array([2, 4, 0, 1])[:, None])

    want_logits, want_caches = jdec.decode_step_multi(
        params, cfg, jcaches, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(fused3),
        control_strength=jnp.asarray(STRENGTH), use_flash=False,
        col_mask_full=jnp.asarray(col))
    got_logits, got_caches = tdec.decode_step_multi(
        model, tcfg, tcaches, _t(token).long(), _t(pos), _t(fused3),
        control_strength=_t(STRENGTH), use_flash=use_flash, col_mask_full=_t(col))

    want_logits = np.asarray(want_logits)
    scale = np.abs(want_logits).max()
    assert scale > 0.1 and np.isfinite(got_logits.numpy()).all()
    err = np.abs(got_logits.numpy() - want_logits).max() / scale
    assert err <= LOGIT_TOL[use_flash], err

    ar = np.arange(b)
    for l in range(cfg.n_layer):
        got = _dequant(got_caches[l], tcfg, split)
        # nothing but the rows at pos[b] changed
        keep = torch.ones(b, S_DEC, dtype=torch.bool)
        keep[ar, pos] = False
        assert torch.equal(got[keep], before[l][keep])
        rows, scales = _port_rows(want_caches[l], jdt, cfg.n_head, cfg.n_head * cfg.head_dim)
        if scales is None:
            # fp32 sums in another order; a bf16 cache may round one value to
            # the neighbouring bf16 step (at most 2**-7 relative); under
            # use_flash the bf16 q of the layers before moves the hidden
            # state, and so the rows, by ~1e-4 of their size
            rtol = 1e-5 if jdt == jnp.float32 else 2 ** -7
            atol = ROW_TOL[use_flash] * np.abs(rows[ar, pos]).max()
            np.testing.assert_allclose(got[ar, pos].numpy(), rows[ar, pos], rtol=rtol,
                                       atol=atol)
            continue
        # the written rows: the JAX package's, within one quantization step
        want_row = {"kv" if jdt == jnp.int8 else "kv4": _t(rows), "s": _t(scales)}
        want_deq = tdec._dequant_slab(want_row, tcfg, torch.float32, split)[ar, pos]
        np.testing.assert_allclose(got_caches[l]["s"][ar, pos].numpy(), scales[ar, pos],
                                   rtol=max(1e-5, ROW_TOL[use_flash]))
        step = _t(np.repeat(scales[ar, pos], cfg.head_dim, axis=-1))
        slack = ROW_TOL[use_flash] * want_deq.abs().max()
        assert bool(((got[ar, pos] - want_deq).abs() <= step * 1.0001 + slack).all())


def test_decode_step_multi_refuses_a_stacked_cache():
    """A stacked cache whose depth is not the model's is refused."""
    _, _, model = _multi_models("float", "c2i")
    tcfg = TGPTConfig(model_type="c2i", dim=256, n_layer=3, n_head=4, vocab_size=96,
                      num_classes=10, block_size=16)
    with pytest.raises(ValueError, match="3 layers"):
        tdec.decode_step_multi(model, tcfg, torch.zeros(2, 2, 32, 512),
                               torch.zeros(2, dtype=torch.long),
                               torch.zeros(2, dtype=torch.int32))


# ---- keyed sampling -----------------------------------------------------------

def test_mul32_is_the_low_32_bits_of_the_product():
    rng = np.random.default_rng(0)
    xs = [0, 1, 2 ** 32 - 1, 2 ** 31] + [int(v) for v in rng.integers(0, 2 ** 32, 200)]
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        got = tsamp._mul32(torch.tensor(xs, dtype=torch.int64), c).tolist()
        assert got == [(x * c) % 2 ** 32 for x in xs]


def test_keyed_uniforms_depend_only_on_seed_and_index():
    seeds = torch.tensor([0, 7, 2 ** 32 - 1, 7], dtype=torch.int64)
    idx = torch.tensor([0, 3, 5, 4], dtype=torch.int64)
    u = tsamp.keyed_uniforms(seeds, idx, 1000)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    for i in range(4):  # alone, a row draws the same numbers as in a batch
        assert torch.equal(tsamp.keyed_uniforms(seeds[i:i + 1], idx[i:i + 1], 1000)[0], u[i])
    assert not torch.equal(u[1], u[3])  # another token index, other numbers
    big = tsamp.keyed_uniforms(torch.arange(64), torch.zeros(64, dtype=torch.int64), 4096)
    assert abs(big.mean().item() - 0.5) < 0.01 and abs(big.std().item() - 12 ** -0.5) < 0.01


def test_sample_keyed_draws_from_the_softmax():
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    n = 20000
    logits = probs.log()[None].repeat(n, 1)
    toks = tsamp.sample_keyed(logits, torch.full((n,), 11), torch.arange(n))
    freq = torch.bincount(toks, minlength=4).float() / n
    assert (freq - probs).abs().max() < 0.015
    again = tsamp.sample_keyed(logits[:50], torch.full((50,), 11), torch.arange(50))
    assert torch.equal(again, toks[:50])


def test_sample_keyed_filters_and_greedy():
    lg = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    seeds, idx = torch.arange(8), torch.arange(8)
    top = torch.topk(lg, 3).indices
    toks = tsamp.sample_keyed(lg, seeds, idx, top_k=3)
    assert bool((top == toks[:, None]).any(-1).all())
    greedy = tsamp.sample_keyed(lg, seeds, idx, temperature=0.5, top_k=3, greedy=True)
    assert torch.equal(greedy, lg.argmax(-1))
