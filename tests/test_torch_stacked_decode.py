"""The stacked (L, B, S, R) KV cache of the port against the port's flat
cache and against the JAX package's stacked cache (CPU).

- Port stacked against port flat, exact on both routes (use_flash=False:
  the masked einsum; use_flash=True: the kernels' plain versions, which
  compute the stacked kernels' function from the flat plain versions):
  prefill rows and logits, the per-slot and the uniform decode step (logits
  and cache contents on admitted slots), greedy `generate(kv_stacked=True)`
  tokens, t2i with left-padded caption masks on an int8 cache.
- Port stacked against the JAX package on the use_flash=False route:
  greedy tokens exact on tiny fp32 models (c2i with f32, int8 and int4
  caches, t2i with masks on an int8 cache); the per-slot stacked step's
  logits within 1e-4 of max |logit| (fp32 sums in another order) and every
  stream of the stacked cache: untouched rows identical, the written rows
  within 1e-6 relative (a bf16 cache within one bf16 step) or one
  quantization step, including the row that the pos >= 1 clamp writes for
  a never-admitted slot.
- The kernel route on the CPU (the plain versions) against the JAX stacked
  kernels in interpret mode inside a full tiny generate: greedy token
  agreement at least the JAX test's own 0.85 (`test_stacked_decode.py`),
  and the first decode step's logits within 1e-2 of max |logit| for bf16
  and int8 caches, 5e-2 for int4 (the Pallas kernels round q, p * vs and
  alpha to bf16; `KERNEL_LOGIT_TOL`), and within 1e-3 of the JAX package's
  plain route.
- `ServeEngine(kv_stacked=True)`: greedy tokens equal to the flat engine's
  and the JAX stacked engine's (bf16 and int8 caches), slot isolation with
  a never-admitted slot, and overlapped admission equal to sync.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import generate as jgen
from controlar_tpu import quant as jquant
from controlar_tpu.config import GPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.ops import cache_append as jca
from controlar_tpu.ops import flash_decode_stacked as jfds
from controlar_tpu.serve.engine import Request as JRequest
from controlar_tpu.serve.engine import ServeConfig as JServeConfig
from controlar_tpu.serve.engine import ServeEngine as JServeEngine
from controlar_tpu_torch import convert
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.cells import serve_requests, serve_staggered
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.serve import Request, ServeConfig, ServeEngine

CACHES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
          "int4": (jnp.int4, "int4")}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _models(model_type="c2i", weights="float", key=0):
    """(JAX cfg, JAX params (unstacked), the port's cfg and model) of a tiny
    fp32 model; weights "w4" quantizes both to W4 in split-rope layout."""
    kw = dict(model_type=model_type, dim=64 if weights == "float" else 256, n_layer=3,
              n_head=4, vocab_size=96, num_classes=10, caption_dim=24,
              cls_token_num=1 if model_type == "c2i" else 6, block_size=16)
    cfg = GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(key), cfg)
    # the t2i head is zero at init; give it weights so greedy tokens vary
    params["output"] = jax.random.normal(jax.random.PRNGKey(key + 1),
                                         params["output"].shape) * 0.5
    params = jdec.unstack_layers(params)
    if weights == "w8":
        params = jquant.quantize_gpt_params(params)
    elif weights == "w4":
        params = jquant.quantize_gpt_params_w4(params, cfg=cfg)
    tcfg = TGPTConfig(**kw)
    return cfg, params, tcfg, convert.gpt_from_jax(_np_tree(params), tcfg)


def _weights_for(cache):
    return "w4" if cache == "int4" else "float"


def _streams(caches):
    """A cache's tensors in a fixed order: per layer, or of the stack."""
    if tdec.is_stacked_caches(caches):
        return [caches[k] for k in sorted(caches)] if isinstance(caches, dict) else [caches]
    return [c[k] for c in caches for k in sorted(c)] if isinstance(caches[0], dict) else caches


def _layer_streams(stacked, l):
    return [s[l] for s in _streams(stacked)]


# ---- port stacked against port flat -----------------------------------------

@pytest.mark.parametrize("cache", list(CACHES))
def test_prefill_stacked_writes_the_flat_rows(cache):
    _, _, tcfg, model = _models(weights=_weights_for(cache))
    tdt = CACHES[cache][1]
    prefix = torch.randn(3, 2, tcfg.dim, generator=torch.Generator().manual_seed(3))
    flat = tdec.init_flat_caches(tcfg, 3, 24, tdt)
    stk = tdec.init_stacked_caches(tcfg, 3, 24, tdt)
    lg_f, flat = tdec.prefill_flat(model, tcfg, flat, prefix, None, None)
    lg_s, stk = tdec.prefill_flat(model, tcfg, stk, prefix, None, None)
    assert torch.equal(lg_f, lg_s)
    assert tdec.is_stacked_caches(stk) and not tdec.is_stacked_caches(flat)
    assert tdec.cache_seq_len(stk) == tdec.cache_seq_len(flat) == 24
    for l in range(tcfg.n_layer):
        want = _streams([flat[l]])
        for got, w in zip(_layer_streams(stk, l), want):
            assert torch.equal(got, w)


def _prefilled(tcfg, model, tdt, b=4, t=2, s=24, seed=5):
    prefix = torch.randn(b, t, tcfg.dim, generator=torch.Generator().manual_seed(seed))
    out = []
    for init in (tdec.init_flat_caches, tdec.init_stacked_caches):
        _, c = tdec.prefill_flat(model, tcfg, init(tcfg, b, s, tdt), prefix, None, None)
        out.append(c)
    return out


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_step_multi_stacked_equals_flat(cache, use_flash):
    """Slots at positions 2, 2, 7 and a never-admitted slot at 0: logits and
    cache contents of the admitted slots are identical; the stacked step
    writes the never-admitted slot's row at position 1 (the clamp)."""
    _, _, tcfg, model = _models(weights=_weights_for(cache))
    flat, stk = _prefilled(tcfg, model, CACHES[cache][1])
    before = [s[:, 3].clone() for s in _streams(stk)]
    tok = torch.tensor([3, 5, 7, 9])
    pos = torch.tensor([2, 2, 7, 0], dtype=torch.int32)
    lg_f, flat = tdec.decode_step_multi(model, tcfg, flat, tok, pos, use_flash=use_flash)
    lg_s, stk = tdec.decode_step_multi(model, tcfg, stk, tok, pos, use_flash=use_flash)
    assert torch.equal(lg_f[:3], lg_s[:3])
    for l in range(tcfg.n_layer):
        want = _streams([flat[l]])
        for got, w, then in zip(_layer_streams(stk, l), want, before):
            assert torch.equal(got[:3], w[:3])
            # the never-admitted slot: only row 1 is written (the clamp)
            assert torch.equal(got[3, 0], then[l, 0]) and torch.equal(got[3, 2:], then[l, 2:])
            assert not torch.equal(got[3, 1], then[l, 1])


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_step_flat_stacked_equals_flat(cache, use_flash):
    _, _, tcfg, model = _models(weights=_weights_for(cache))
    flat, stk = _prefilled(tcfg, model, CACHES[cache][1])
    for i, tok in enumerate(([3, 5, 7, 9], [1, 2, 3, 4])):
        tok = torch.tensor(tok)
        lg_f, flat = tdec.decode_step_flat(model, tcfg, flat, tok, 2 + i, None, None,
                                           use_flash=use_flash)
        lg_s, stk = tdec.decode_step_flat(model, tcfg, stk, tok, 2 + i, None, None,
                                          use_flash=use_flash)
        assert torch.equal(lg_f, lg_s)
    for l in range(tcfg.n_layer):
        want = _streams([flat[l]])
        for got, w in zip(_layer_streams(stk, l), want):
            assert torch.equal(got, w)


def test_a_stacked_cache_of_another_depth_is_refused():
    _, _, tcfg, model = _models()
    stk = tdec.init_stacked_caches(tcfg, 2, 24, torch.float32)[:2]
    with pytest.raises(ValueError, match="layers"):
        tdec.decode_step_flat(model, tcfg, stk, torch.tensor([1, 2]), 2, None, None,
                              use_flash=False)


def _features(tcfg, b, seed=4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((b, tcfg.block_size, 384)) * 0.5
                             ).astype(np.float32))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("cache", list(CACHES))
def test_generate_stacked_equals_flat(cache, use_flash):
    _, _, tcfg, model = _models(weights=_weights_for(cache))
    kw = dict(labels=torch.arange(3), adapter_features=_features(tcfg, 3),
              max_new_tokens=tcfg.block_size, cfg_scale=2.0, sample_logits=False,
              cache_dtype=CACHES[cache][1], use_flash=use_flash, device="cpu")
    flat = tgen.generate(model, tcfg, kv_stacked=False, **kw)
    stk = tgen.generate(model, tcfg, kv_stacked=True, **kw)
    assert len(torch.unique(flat)) > 4  # a real token stream
    assert torch.equal(flat, stk)


def _t2i_inputs(tcfg, b=2):
    rng = np.random.default_rng(5)
    cap = rng.standard_normal((b, tcfg.cls_token_num, tcfg.caption_dim)).astype(np.float32)
    masks = np.ones((b, tcfg.cls_token_num), bool)
    masks[0, :3] = False  # left padding
    return cap, masks


@pytest.mark.parametrize("use_flash", [False, True])
def test_generate_stacked_t2i_emb_masks_equals_flat(use_flash):
    _, _, tcfg, model = _models("t2i", key=4)
    cap, masks = _t2i_inputs(tcfg)
    kw = dict(caption_emb=torch.from_numpy(cap), emb_masks=torch.from_numpy(masks),
              max_new_tokens=tcfg.block_size, cfg_scale=3.0, sample_logits=False,
              cache_dtype=torch.int8, use_flash=use_flash, device="cpu")
    assert torch.equal(tgen.generate(model, tcfg, kv_stacked=False, **kw),
                       tgen.generate(model, tcfg, kv_stacked=True, **kw))


# ---- port stacked against the JAX package --------------------------------------

GREEDY_CASES = {"c2i_f32": ("c2i", "f32"), "c2i_int8": ("c2i", "int8"),
                "c2i_w4split_int4": ("c2i", "int4"), "t2i_int8_emb_masks": ("t2i", "int8")}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_tokens_match_jax_stacked(case):
    model_type, cache = GREEDY_CASES[case]
    cfg, params, tcfg, model = _models(model_type, _weights_for(cache),
                                       key=4 if model_type == "t2i" else 0)
    jdt, tdt = CACHES[cache]
    opts = dict(max_new_tokens=cfg.block_size, cfg_scale=3.0, sample_logits=False,
                use_flash=False, kv_stacked=True)
    if model_type == "c2i":
        feats = _features(tcfg, 3)
        cond = dict(labels=np.arange(3, dtype=np.int32) * 3, adapter_features=feats.numpy())
    else:
        cap, masks = _t2i_inputs(tcfg)
        cond = dict(caption_emb=cap, emb_masks=masks)
    want = jgen.generate(params, cfg, **{k: jnp.asarray(v) for k, v in cond.items()},
                         cache_dtype=jdt, rng=jax.random.PRNGKey(0), **opts)
    got = tgen.generate(model, tcfg, **{k: torch.from_numpy(np.asarray(v))
                                        for k, v in cond.items()},
                        cache_dtype=tdt, device="cpu", **opts)
    assert len(np.unique(np.asarray(want))) > 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


S_DEC = 32
STRENGTH = np.array([0.8, 1.0, 1.2, 0.5], np.float32)[:, None, None]
MULTI_CASES = {  # weights, model type, cache
    "c2i_fp32": ("float", "c2i", "f32"),
    "t2i_bf16_colmask": ("float", "t2i", "bf16"),
    "c2i_w8_kv8": ("w8", "c2i", "int8"),
    "t2i_w4split_kv4": ("w4", "t2i", "int4"),
}


def _random_stacks(cfg, cache, rng):
    """Random stacked cache contents: (JAX cache, the port's)."""
    n, b, h, d = cfg.n_layer, 4, cfg.n_head, cfg.head_dim
    hd = h * d
    if cache in ("int8", "int4"):
        scales = rng.uniform(0.002, 0.02, (n, b, S_DEC, 2 * h)).astype(np.float32)
        s_pad = np.pad(scales, [(0, 0)] * 3 + [(0, jdec.scale_pad(h) - 2 * h)])
        if cache == "int8":
            rows = rng.integers(-127, 128, (n, b, S_DEC, 2 * hd)).astype(np.int8)
            return ({"kv": jnp.asarray(rows), "s": jnp.asarray(s_pad)},
                    {"kv": _t(rows), "s": _t(scales)})
        carriers = rng.integers(-128, 128, (n, b, S_DEC, 2, hd // 2)).astype(np.int8)
        w = jquant.kv4_row_width(h, d)
        padded = np.pad(carriers, [(0, 0)] * 4 + [(0, w - hd // 2)])
        return ({"kv4": jnp.asarray(padded.reshape(n, b, S_DEC, 2 * w)), "s": jnp.asarray(s_pad)},
                {"kv4": _t(carriers.reshape(n, b, S_DEC, hd)), "s": _t(scales)})
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    slab = jnp.asarray(rng.standard_normal((n, b, S_DEC, 2 * hd)) * 0.5, jdt)
    return slab, _t(slab)


def _port_layout(jcache, cache, cfg):
    """The JAX stacked cache cut to the port's unpadded widths: (rows, scales
    or None), rows as float for a float cache."""
    h, hd = cfg.n_head, cfg.n_head * cfg.head_dim
    if cache == "int8":
        return np.asarray(jcache["kv"]), np.asarray(jcache["s"])[..., : 2 * h]
    if cache == "int4":
        c = np.asarray(jcache["kv4"])
        return (c.reshape(*c.shape[:-1], 2, -1)[..., : hd // 2].reshape(*c.shape[:-1], hd),
                np.asarray(jcache["s"])[..., : 2 * h])
    return np.asarray(jcache.astype(jnp.float32)), None


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_decode_step_multi_stacked_matches_jax(case):
    weights, model_type, cache = MULTI_CASES[case]
    cfg, params, tcfg, model = _models(model_type, weights)
    rng = np.random.default_rng(3)
    b = 4
    split = weights == "w4"
    jcaches, tcaches = _random_stacks(cfg, cache, rng)
    before = [s.clone() for s in _streams(tcaches)]
    stop = cfg.cls_token_num + cfg.block_size - 1
    # mid-block, deeper, never admitted (clamped to 1), frozen at the last position
    pos = np.array([cfg.cls_token_num + 3, cfg.cls_token_num + 10, 0, stop], np.int32)
    token = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    fused3 = (rng.standard_normal((3, b, cfg.block_size, cfg.dim)) * 0.5).astype(np.float32)
    col = np.ones((b, S_DEC), bool)
    if model_type == "t2i":  # left padding; the never-admitted slot keeps all columns
        col[:, : cfg.cls_token_num] = (np.arange(cfg.cls_token_num)[None, :]
                                       >= np.array([2, 4, 0, 1])[:, None])
    want_logits, want = jdec.decode_step_multi(
        params, cfg, jcaches, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(fused3),
        control_strength=jnp.asarray(STRENGTH), use_flash=False,
        col_mask_full=jnp.asarray(col))
    got_logits, got = tdec.decode_step_multi(
        model, tcfg, tcaches, _t(token).long(), _t(pos), _t(fused3),
        control_strength=_t(STRENGTH), use_flash=False, col_mask_full=_t(col))
    assert got is tcaches  # written in place

    want_logits = np.asarray(want_logits)
    scale = np.abs(want_logits).max()
    assert scale > 0.1 and np.isfinite(got_logits.numpy()).all()
    assert np.abs(got_logits.numpy() - want_logits).max() <= 1e-4 * scale

    written = np.maximum(pos, 1)  # the clamp
    ar = np.arange(b)
    rows, scales = _port_layout(want, cache, cfg)
    streams = _streams(got)
    # every stream: nothing but the rows at the clamped positions changed
    for now, then in zip(streams, before):
        keep = torch.ones(now.shape[:3], dtype=torch.bool)
        keep[:, ar, written] = False
        assert torch.equal(now[keep], then[keep])
    if scales is None:
        # fp32 sums in another order; a bf16 cache may round a value to the
        # neighbouring bf16 step (2**-7 relative)
        rtol = 1e-5 if cache == "f32" else 2 ** -7
        new = streams[0][:, ar, written].float().numpy()
        np.testing.assert_allclose(new, rows[:, ar, written], rtol=rtol,
                                   atol=1e-6 * np.abs(rows[:, ar, written]).max())
        return
    np.testing.assert_allclose(got["s"][:, ar, written].numpy(), scales[:, ar, written],
                               rtol=1e-5)
    key = "kv" if cache == "int8" else "kv4"
    for l in range(cfg.n_layer):
        want_l = {key: _t(rows[l]), "s": _t(scales[l])}
        got_l = {key: got[key][l], "s": got["s"][l]}
        want_deq = tdec._dequant_slab(want_l, tcfg, torch.float32, split)[ar, written]
        got_deq = tdec._dequant_slab(got_l, tcfg, torch.float32, split)[ar, written]
        # within one quantization step of the JAX package's rows
        step = _t(np.repeat(scales[l][ar, written], cfg.head_dim, axis=-1))
        assert bool(((got_deq - want_deq).abs() <= step * 1.0001).all())


# ---- the kernel route against the JAX stacked kernels (interpret mode) --------

def _interpret(fn):
    """Run fn with the JAX stacked kernels and append in interpret mode."""
    jfds.INTERPRET = jca.INTERPRET = True
    try:
        return fn()
    finally:
        jfds.INTERPRET = jca.INTERPRET = False


def test_generate_kernel_route_tracks_the_jax_kernels():
    cfg, params, tcfg, model = _models(key=1)
    kw = dict(max_new_tokens=cfg.block_size, cfg_scale=2.0, sample_logits=False,
              kv_stacked=True, use_flash=True)
    want = _interpret(lambda: np.asarray(jgen.generate(
        params, cfg, labels=jnp.arange(2), rng=jax.random.PRNGKey(0), **kw)))
    got = tgen.generate(model, tcfg, labels=torch.arange(2), device="cpu", **kw).numpy()
    assert (got == want).mean() >= 0.85, (got, want)


# relative to max |logit|: the Pallas kernels round q, p * vs and alpha to
# bf16 (1.7e-3 from the JAX package's own plain route on this model for bf16
# and int8); the int4 kernel lands 3.0e-2 from that route, the port's plain
# versions within 1e-4 of it
KERNEL_LOGIT_TOL = {"bf16": 1e-2, "int8": 1e-2, "int4": 5e-2}


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_first_stacked_step_logits_match_the_jax_kernels(cache):
    """Prefill, then one uniform decode step through the stacked kernels:
    the plain versions against the Pallas kernels in interpret mode, and
    against the JAX package's plain route (within 1e-3)."""
    cfg, params, tcfg, model = _models(weights=_weights_for(cache))
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": CACHES["int8"],
                "int4": CACHES["int4"]}[cache]
    prefix = np.random.default_rng(6).standard_normal((3, 1, cfg.dim)).astype(np.float32)
    tok = np.array([3, 5, 7], np.int32)

    def jax_step(use_flash):
        c = jdec.init_stacked_caches(cfg, 3, 256, jdt)
        _, c = jdec.prefill_flat(params, cfg, c, jnp.asarray(prefix), None, None)
        lg, _ = jdec.decode_step_flat(params, cfg, c, jnp.asarray(tok), 1, None, None,
                                      use_flash=use_flash)
        return np.asarray(lg)

    want = _interpret(lambda: jax_step(True))
    plain = jax_step(False)
    c = tdec.init_stacked_caches(tcfg, 3, 256, tdt)
    _, c = tdec.prefill_flat(model, tcfg, c, torch.from_numpy(prefix), None, None)
    got, _ = tdec.decode_step_flat(model, tcfg, c, torch.from_numpy(tok).long(), 1, None, None,
                                   use_flash=True)
    scale = np.abs(plain).max()
    assert scale > 0.1
    assert np.abs(got.numpy() - want).max() <= KERNEL_LOGIT_TOL[cache] * scale
    assert np.abs(got.numpy() - plain).max() <= 1e-3 * scale


# ---- ServeEngine(kv_stacked=True) ------------------------------------------------

ENGINE_CASES = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("cache", list(ENGINE_CASES))
def test_engine_stacked_matches_flat_and_jax(cache):
    cfg, params, tcfg, model = _models()
    jdt, tdt = ENGINE_CASES[cache]
    labels = [1, 2, 3, 7]
    kw = dict(max_slots=2, quantum=5, greedy=True, top_k=0, use_flash=False)
    jeng = JServeEngine(params, cfg, JServeConfig(cache_dtype=jdt, kv_stacked=True, **kw))
    want = [r.tokens for r in jeng.run([JRequest(request_id=i, label=l, cfg_scale=2.0)
                                        for i, l in enumerate(labels)])]

    def run(stacked):
        eng = ServeEngine(model, tcfg, ServeConfig(cache_dtype=tdt, kv_stacked=stacked, **kw),
                          device="cpu")
        done = eng.run([Request(request_id=i, label=l, cfg_scale=2.0)
                        for i, l in enumerate(labels)])
        return [r.tokens for r in done], dict(eng.stats)

    (flat, stats_f), (stk, stats_s) = run(False), run(True)
    assert stats_f == stats_s == dict(jeng.stats)
    assert len(np.unique(np.concatenate(want))) > 4
    for a, b, c in zip(flat, stk, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def _stacked_engine(model, tcfg, overlap=False):
    return ServeEngine(model, tcfg, ServeConfig(
        max_slots=2, quantum=6, top_k=8, cache_dtype=torch.float32, use_flash=True,
        kv_stacked=True, overlap_admission=overlap), device="cpu")


def test_engine_stacked_slot_isolation():
    """Request 0 alone (slot 1 never admitted, so the pos >= 1 clamp runs
    every step) and with a neighbour admitted one step() later: its sampled
    tokens are bit-identical, through the kernels' plain versions and the
    stacked append."""
    _, _, tcfg, model = _models()

    def run(n):
        return serve_staggered(_stacked_engine(model, tcfg),
                               serve_requests(n, num_classes=10, cfg_scale=2.0),
                               upfront=1, add_after_step=1)

    solo, duo = run(1), run(2)
    assert solo[0].tokens.shape == (tcfg.block_size,)
    np.testing.assert_array_equal(solo[0].tokens, duo[0].tokens)
    assert not np.array_equal(duo[0].tokens, duo[1].tokens)


def test_engine_stacked_overlap_matches_sync():
    _, _, tcfg, model = _models(key=1)
    out = []
    for overlap in (False, True):
        eng = _stacked_engine(model, tcfg, overlap)
        reqs = serve_requests(5, num_classes=10, cfg_scale=2.0)
        out.append((serve_staggered(eng, reqs, upfront=3, add_after_step=2), dict(eng.stats)))
    (sync, st_s), (over, st_o) = out
    assert st_s == st_o and len(sync) == len(over) == 5
    for a, b in zip(sync, over):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_engine_stacked_keeps_one_stacked_cache():
    _, _, tcfg, model = _models()
    eng = ServeEngine(model, tcfg, ServeConfig(max_slots=2, cache_dtype=torch.int8,
                                               kv_stacked=True), device="cpu")
    assert isinstance(eng.caches, dict) and tdec.is_stacked_caches(eng.caches)
    assert eng.caches["kv"].shape == (tcfg.n_layer, 4, eng.s_max, 2 * tcfg.dim)
    assert eng.caches["s"].shape == (tcfg.n_layer, 4, eng.s_max, 2 * tcfg.n_head)
