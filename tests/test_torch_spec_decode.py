"""Speculative decode in the port against the JAX package's (CPU).

- `decode_step_multi` at positions past the RoPE table (a finished row in
  speculative decode): the table index is clamped, as JAX's gather clamps;
- `forward_chunk` against the JAX package's for fp32, W8 + int8-cache and
  W4 split-rope + int4-cache models, c2i and t2i with a caption mask, the
  plain route and the kernels' plain versions, at per-row positions that
  include the end of the block (the control rows' clamped slice) and rows
  past the table;
- `_mix_rowwise`, `prefill_chunked`, `speculative_accept`'s distribution;
- greedy `generate_spec` token for token against the JAX package's
  `generate_spec` and the port's greedy `generate`, for the drafts of the
  JAX package's own spec tests, and `ControlARPipeline.generate(spec_draft=...)`.

Tolerances are stated where they are used.
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
from controlar_tpu import spec_decode as jspec
from controlar_tpu.config import GPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu_torch import convert
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import spec_decode as tspec
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq
from controlar_tpu_torch.pipeline import ControlARPipeline


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tcfg(cfg: GPTConfig) -> TGPTConfig:
    return TGPTConfig(**{f: getattr(cfg, f) for f in (
        "model_type", "dim", "n_layer", "n_head", "vocab_size", "num_classes", "caption_dim",
        "cls_token_num", "block_size")})


# ---- models and caches, the same contents in both packages -------------------

S_DEC = 32
K_CHUNK = 4


@functools.lru_cache(maxsize=None)
def _models(weights, model_type):
    """(JAX cfg, JAX params (unstacked), the port's model) of a small model:
    fp32 weights, W8, or W4 split-rope."""
    cfg = GPTConfig(model_type=model_type, dim=256, n_layer=3, n_head=4, vocab_size=96,
                    num_classes=10, caption_dim=24,
                    cls_token_num=1 if model_type == "c2i" else 6, block_size=16)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)
    params["output"] = jax.random.normal(jax.random.PRNGKey(1), params["output"].shape) * 0.5
    params = jdec.unstack_layers(params)
    if weights == "w8":
        params = jquant.quantize_gpt_params(params)
    elif weights == "w4":
        params = jquant.quantize_gpt_params_w4(params, cfg=cfg)
    return cfg, params, convert.gpt_from_jax(_np_tree(params), _tcfg(cfg))


def _caches(cfg, jdt, b, rng):
    """Random cache contents in both packages' layouts: (JAX tuple, port
    list). The JAX package pads the scales to 128 lanes and each half of an
    int4 row to a multiple of 128 bytes."""
    h, d = cfg.n_head, cfg.head_dim
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
            slab = (rng.standard_normal((b, S_DEC, 2 * hd)) * 0.5).astype(np.float32)
            jc.append(jnp.asarray(slab))
            tc.append(_t(slab))
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
    return np.asarray(cache), None


def _dequant(cache, cfg, split):
    if isinstance(cache, dict):
        return tdec._dequant_slab(cache, cfg, torch.float32, split)
    return cache.float()


# logits against the JAX package, relative to max |logit|:
# - plain route (use_flash=False): the same fp32 arithmetic, sums in another
#   order (~1e-6);
# - the kernels' plain versions (use_flash=True) round q to bf16 as the
#   kernels read it (2**-9 relative per element), ~1e-3 of the logits;
# - a quantized cache may round one new element to the neighbouring int8 or
#   int4 step when its fp32 value differs in the last bits, moving the logits
#   by up to a few 1e-3.
LOGIT_TOL = {False: 1e-4, True: 1e-2}
ROW_TOL = {False: 1e-6, True: 1e-3}  # written float rows, relative to max |row|


def _check_rows(got_cache, want_cache, before, rows_at, cfg, tcfg, jdt, split, use_flash):
    """The port's cache changed exactly at rows_at (a boolean (B, S) mask),
    where it holds the JAX package's rows: fp32 rows within ROW_TOL, the
    quantized ones within one quantization step."""
    got = _dequant(got_cache, tcfg, split)
    assert torch.equal(got[~rows_at], before[~rows_at])
    rows, scales = _port_rows(want_cache, jdt, cfg.n_head, cfg.n_head * cfg.head_dim)
    at = rows_at.numpy()
    if scales is None:
        atol = ROW_TOL[use_flash] * np.abs(rows[at]).max()
        np.testing.assert_allclose(got[rows_at].numpy(), rows[at], rtol=1e-5, atol=atol)
        return
    want_row = {"kv" if jdt == jnp.int8 else "kv4": _t(rows), "s": _t(scales)}
    want_deq = tdec._dequant_slab(want_row, tcfg, torch.float32, split)[rows_at]
    np.testing.assert_allclose(got_cache["s"][rows_at].numpy(), scales[at],
                               rtol=max(1e-5, ROW_TOL[use_flash]))
    step = _t(np.repeat(scales[at], cfg.head_dim, axis=-1))
    slack = ROW_TOL[use_flash] * want_deq.abs().max()
    assert bool(((got[rows_at] - want_deq).abs() <= step * 1.0001 + slack).all())


# ---- the repair: RoPE rows past the table -------------------------------------

@pytest.mark.parametrize("weights,jdt", [("float", jnp.float32), ("w4", jnp.int4)])
def test_decode_step_multi_past_the_rope_table_matches_jax(weights, jdt):
    """A finished row of a speculative decode keeps cycling at positions up
    to 2k - 3 past the table (cls_token_num + block_size rows); the JAX
    gather clamps the index there, and so does the port (it raised an
    IndexError before)."""
    cfg, params, model = _models(weights, "c2i")
    tcfg = _tcfg(cfg)
    rng = np.random.default_rng(11)
    b = 4
    split = weights == "w4"
    jcaches, tcaches = _caches(cfg, jdt, b, rng)
    table_rows = cfg.cls_token_num + cfg.block_size
    pos = np.array([5, table_rows + 2, table_rows - 1, table_rows], np.int32)
    token = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    fused3 = (rng.standard_normal((3, b, cfg.block_size, cfg.dim)) * 0.5).astype(np.float32)
    before = [_dequant(c, tcfg, split).clone() for c in tcaches]
    want_logits, want_caches = jdec.decode_step_multi(
        params, cfg, jcaches, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(fused3),
        use_flash=False)
    got_logits, got_caches = tdec.decode_step_multi(
        model, tcfg, tcaches, _t(token).long(), _t(pos), _t(fused3), use_flash=False)
    want_logits = np.asarray(want_logits)
    err = np.abs(got_logits.numpy() - want_logits).max() / np.abs(want_logits).max()
    assert err <= LOGIT_TOL[False], err
    at = torch.zeros(b, S_DEC, dtype=torch.bool)
    at[torch.arange(b), _t(pos).long()] = True
    for l in range(cfg.n_layer):
        _check_rows(got_caches[l], want_caches[l], before[l], at, cfg, tcfg, jdt, split, False)


def test_rope_rows_clamp_into_the_table():
    table = torch.arange(5 * 2 * 2, dtype=torch.float32).reshape(5, 2, 2)
    got = tdec._rope_at(table, torch.tensor([3, 7], dtype=torch.int32))
    assert torch.equal(got[:, 0], table[[3, 4]])  # JAX: t[jnp.array([3, 7])] -> rows 3, 4
    got = tdec._rope_at((table[..., 0], table[..., 1]), torch.tensor([[0, 6]]))
    assert torch.equal(got[0][0], table[[0, 4], :, 0])


# ---- forward_chunk ------------------------------------------------------------

# weights, model type, JAX cache dtype, the port's
CHUNK_CASES = {
    "c2i_fp32": ("float", "c2i", jnp.float32),
    "t2i_fp32_colmask": ("float", "t2i", jnp.float32),
    "c2i_w8_kv8": ("w8", "c2i", jnp.int8),
    "t2i_w4split_kv4": ("w4", "t2i", jnp.int4),
}


def _chunk_positions(cfg):
    """A chunk mid-block, one at the end of the block (its control rows are
    the clamped slice, shifted back), one of a finished row past the RoPE
    table, and one starting inside the prefix."""
    t, bs = cfg.cls_token_num, cfg.block_size
    return np.array([t + 3, t + bs - 2, t + bs + 1, max(t - 5, 0)], np.int32)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_forward_chunk_matches_jax(case, use_flash):
    weights, model_type, jdt = CHUNK_CASES[case]
    cfg, params, model = _models(weights, model_type)
    tcfg = _tcfg(cfg)
    rng = np.random.default_rng(5)
    b, k = 4, K_CHUNK
    split = weights == "w4"
    jcaches, tcaches = _caches(cfg, jdt, b, rng)
    before = [_dequant(c, tcfg, split).clone() for c in tcaches]
    pos = _chunk_positions(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (b, k)).astype(np.int32)
    fused3 = (rng.standard_normal((3, b, cfg.block_size, cfg.dim)) * 0.5).astype(np.float32)
    col = None
    if model_type == "t2i":  # left padding; row 3's chunk masks its own rows
        col = np.ones((b, S_DEC), bool)
        col[:, : cfg.cls_token_num] = (np.arange(cfg.cls_token_num)[None, :]
                                       >= np.array([2, 4, 0, 5])[:, None])
    want_logits, want_caches = jspec.forward_chunk(
        params, cfg, jcaches, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(fused3),
        None if col is None else jnp.asarray(col), 0.8, use_flash=False)
    got_logits, got_caches = tspec.forward_chunk(
        model, tcfg, tcaches, _t(tokens).long(), _t(pos), _t(fused3),
        None if col is None else _t(col), 0.8, use_flash=use_flash)

    want_logits = np.asarray(want_logits)
    assert got_logits.shape == (b, k, cfg.vocab_size)
    scale = np.abs(want_logits).max()
    assert scale > 0.1 and np.isfinite(got_logits.numpy()).all()
    err = np.abs(got_logits.numpy() - want_logits).max() / scale
    assert err <= LOGIT_TOL[use_flash], err
    at = torch.zeros(b, S_DEC, dtype=torch.bool)
    for i, p in enumerate(pos):
        at[i, p:p + k] = True
    for l in range(cfg.n_layer):
        _check_rows(got_caches[l], want_caches[l], before[l], at, cfg, tcfg, jdt, split,
                    use_flash)


def test_forward_chunk_at_the_block_end_reads_the_shifted_control_rows():
    """The reference's clamped slice: a chunk that runs past the block reads
    control rows shifted back, so even its valid positions differ from K
    sequential decode steps; a chunk inside the block equals them."""
    cfg, params, model = _models("float", "c2i")
    tcfg = _tcfg(cfg)
    rng = np.random.default_rng(8)
    k = K_CHUNK
    _, tcaches = _caches(cfg, jnp.float32, 2, rng)
    pos = np.array([3, cfg.cls_token_num + cfg.block_size - 3], np.int32)
    tokens = _t(rng.integers(0, cfg.vocab_size, (2, k))).long()
    fused3 = _t((rng.standard_normal((3, 2, cfg.block_size, cfg.dim)) * 0.5).astype(np.float32))
    seq_caches = [c.clone() for c in tcaches]
    seq = []
    for j in range(k):
        lg, seq_caches = tdec.decode_step_multi(model, tcfg, seq_caches, tokens[:, j],
                                                _t(pos + j), fused3, use_flash=False)
        seq.append(lg)
    seq = torch.stack(seq, dim=1)
    got, _ = tspec.forward_chunk(model, tcfg, tcaches, tokens, _t(pos), fused3, use_flash=False)
    torch.testing.assert_close(got[0], seq[0], rtol=1e-4, atol=1e-4)
    assert (got[1, 0] - seq[1, 0]).abs().max() > 1e-2


# ---- pieces of the cycle --------------------------------------------------------

@pytest.mark.parametrize("cfg_interval", [-1, 5])
@pytest.mark.parametrize("with_k", [False, True])
def test_mix_rowwise_matches_jax(cfg_interval, with_k):
    rng = np.random.default_rng(cfg_interval + 3)
    shape = (6, 4, 32) if with_k else (6, 32)
    logits = rng.standard_normal(shape).astype(np.float32)
    n_row = np.array([1, 6, 9], np.int32)
    want = jspec._mix_rowwise(jnp.asarray(logits), jnp.asarray(n_row), 3.0, cfg_interval, 0)
    got = tspec._mix_rowwise(_t(logits), _t(n_row).long(), 3.0, cfg_interval)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    no_cfg = _t(logits)
    assert tspec._mix_rowwise(no_cfg, _t(n_row), 1.0, cfg_interval) is no_cfg


def test_prefill_chunked_matches_prefill_flat_and_jax():
    """t2i with fully left-padded rows and control on the last prefix
    position. Chunked attention sums in another order than one pass: 3e-4
    on the logits, as the JAX package's own test allows."""
    cfg = GPTConfig(model_type="t2i", dim=64, n_layer=2, n_head=4, cls_token_num=12,
                    block_size=16, vocab_size=64, caption_dim=48)
    params = jdec.unstack_layers(jgpt.init_gpt_params(jax.random.PRNGKey(5), cfg))
    params["output"] = jax.random.normal(jax.random.PRNGKey(6), params["output"].shape) * 0.5
    tcfg = _tcfg(cfg)
    model = convert.gpt_from_jax(_np_tree(params), tcfg)
    rng = np.random.default_rng(0)
    b, s_max = 2, 64
    prefix = rng.standard_normal((b, 12, cfg.dim)).astype(np.float32)
    col_mask = np.array([[0] * 5 + [1] * 7, [0] * 2 + [1] * 10], bool)
    fused3 = (rng.standard_normal((3, b, cfg.block_size, cfg.dim)) * 0.1).astype(np.float32)
    flat_l, flat_c = tdec.prefill_flat(model, tcfg, tdec.init_flat_caches(tcfg, b, s_max,
                                                                          torch.float32),
                                       _t(prefix), _t(fused3), _t(col_mask), 0.8)
    for chunk in (4, 5, 12):
        want_l, want_c = jspec.prefill_chunked(
            params, cfg, jdec.init_flat_caches(cfg, b, s_max, jnp.float32), jnp.asarray(prefix),
            jnp.asarray(fused3), jnp.asarray(col_mask), 0.8, chunk=chunk, use_flash=False)
        for use_flash in (False, True):
            got_l, got_c = tspec.prefill_chunked(
                model, tcfg, tdec.init_flat_caches(tcfg, b, s_max, torch.float32), _t(prefix),
                _t(fused3), _t(col_mask), 0.8, chunk=chunk, use_flash=use_flash)
            # use_flash: the kernels' plain versions read q as bf16 (2**-9)
            tol = 3e-2 if use_flash else 3e-4
            np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=tol, atol=tol)
            np.testing.assert_allclose(got_l.numpy(), flat_l.numpy(), rtol=tol, atol=tol)
            for l in range(cfg.n_layer):
                np.testing.assert_allclose(got_c[l][:, :12].numpy(),
                                           np.asarray(want_c[l])[:, :12], rtol=tol, atol=tol)
                np.testing.assert_allclose(got_c[l][:, :12].numpy(), flat_c[l][:, :12].numpy(),
                                           rtol=tol, atol=tol)


def test_accept_preserves_the_target_distribution():
    """K = 2 (one draft): the first emitted token follows p whatever q is.
    200k trials per (p, q) pair, 4 sigma of a binomial per class; the
    acceptance rate is sum(min(p, q)) within 0.01."""
    v, n = 6, 200_000
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for trial in range(3):
        p = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32))
        q = torch.from_numpy(rng.dirichlet(np.ones(v) * (0.3 + trial)).astype(np.float32))
        drafts = torch.multinomial(q, n, replacement=True, generator=gen)[:, None]
        qprobs = q.expand(n, 1, v)
        pprobs = p.expand(n, 2, v)
        m, tokens_row, cur = tspec.speculative_accept(drafts, qprobs, pprobs, gen)
        emitted = tokens_row[:, 0]
        assert torch.equal(cur, tokens_row[torch.arange(n), m])
        freq = torch.bincount(emitted, minlength=v).double() / n
        tol = 4 * torch.sqrt(p.double() * (1 - p.double()) / n) + 1e-4
        assert bool(((freq - p.double()).abs() <= tol).all()), (freq, p, tol)
        assert abs(m.double().mean().item() - torch.minimum(p, q).sum().item()) < 0.01


def test_accept_identical_distributions_accepts_everything():
    v, n, km1 = 8, 4096, 3
    gen = torch.Generator().manual_seed(1)
    drafts = torch.randint(0, v, (n, km1), generator=gen)
    probs = torch.full((n, km1 + 1, v), 1.0 / v)
    m, tokens_row, _ = tspec.speculative_accept(drafts, probs[:, :km1], probs, gen)
    assert int(m.min()) == km1
    assert torch.equal(tokens_row[:, :km1], drafts)


# ---- greedy generate_spec: the target's own greedy tokens -------------------

def _c2i_cfg(**kw):
    d = dict(model_type="c2i", dim=64, n_layer=3, n_head=4, cls_token_num=1, block_size=16,
             vocab_size=96, num_classes=10)
    d.update(kw)
    return GPTConfig(**d)


def _pair(cfg, seed):
    params = jgpt.init_gpt_params(jax.random.PRNGKey(seed), cfg)
    if cfg.model_type == "t2i":  # the t2i head is zero at init; greedy tokens would be 0
        params["output"] = jax.random.normal(jax.random.PRNGKey(seed + 1),
                                             params["output"].shape) * 0.5
    return params, convert.gpt_from_jax(_np_tree(params), _tcfg(cfg))


def _assert_spec_greedy(cfg, params, model, jdraft, tdraft, dcfg=None, *, k, inputs,
                        cache=(jnp.float32, torch.float32), draft_cache=None, use_flash=False,
                        **opts):
    """Greedy generate_spec: the port's tokens equal the JAX package's and
    the port's greedy generate's; returns the port's stats."""
    jin = {key: jnp.asarray(v) for key, v in inputs.items()}
    tin = {key: _t(v) for key, v in inputs.items()}
    jdc = tdc = None
    if draft_cache is not None:
        jdc, tdc = draft_cache
    want = np.asarray(jspec.generate_spec(
        params, cfg, jdraft, dcfg, max_new_tokens=cfg.block_size, k_draft=k,
        cache_dtype=cache[0], draft_cache_dtype=jdc, use_flash=False, **jin, **opts))
    tcfg = _tcfg(cfg)
    got, stats = tspec.generate_spec(
        model, tcfg, tdraft, None if dcfg is None else _tcfg(dcfg),
        max_new_tokens=cfg.block_size, k_draft=k, cache_dtype=cache[1], draft_cache_dtype=tdc,
        use_flash=use_flash, return_stats=True, device="cpu", **tin, **opts)
    plain = tgen.generate(model, tcfg, max_new_tokens=cfg.block_size, sample_logits=False,
                          cache_dtype=cache[1], use_flash=use_flash, device="cpu", **tin, **opts)
    assert len(np.unique(want)) > 2  # a real token stream, not one id
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert 1.0 <= stats["accepted_per_cycle"] <= k and stats["k_draft"] == k
    assert stats["loop_iters"] >= -(-(cfg.block_size - 1) // k)
    return stats


@pytest.mark.parametrize("use_flash", [False, True])
def test_spec_greedy_c2i_cfg_int8_self_draft(use_flash):
    """use_flash=True runs the plain versions of the decode and chunk
    kernels (q read as bf16) in both decode loops."""
    cfg = _c2i_cfg()
    params, model = _pair(cfg, 0)
    jq = jquant.quantize_gpt_params(params)
    tq = convert.gpt_from_jax(_np_tree(jq), _tcfg(cfg))
    feats = np.random.default_rng(0).standard_normal((4, 16, 384)).astype(np.float32)
    stats = _assert_spec_greedy(cfg, params, model, jq, tq, k=4, use_flash=use_flash,
                                inputs=dict(labels=np.arange(4), adapter_features=feats),
                                cfg_scale=2.0, cfg_interval=14)
    assert stats["accepted_per_cycle"] > 1.2  # int8 drafts of the same model mostly agree


def test_spec_greedy_unrelated_draft():
    """A draft of unrelated random weights: the same tokens, fewer accepted."""
    cfg = _c2i_cfg()
    params, model = _pair(cfg, 0)
    jjunk, tjunk = _pair(cfg, 7)
    stats = _assert_spec_greedy(cfg, params, model, jjunk, tjunk, k=4,
                                inputs=dict(labels=np.arange(4)), cfg_scale=2.0,
                                cfg_interval=14)
    assert stats["accepted_per_cycle"] < 2.0


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_spec_greedy_no_cfg_k_sweep(k):
    cfg = _c2i_cfg(n_layer=2)
    params, model = _pair(cfg, 1)
    jq = jquant.quantize_gpt_params(params)
    tq = convert.gpt_from_jax(_np_tree(jq), _tcfg(cfg))
    _assert_spec_greedy(cfg, params, model, jq, tq, k=k, inputs=dict(labels=np.array([3, 5])),
                        cfg_scale=1.0)


def test_spec_greedy_cross_size_draft_int8_cache():
    """A smaller family member drafting, the target on the int8 cache, the
    draft on a bf16 one."""
    cfg = _c2i_cfg()
    dcfg = _c2i_cfg(dim=32, n_layer=2, n_head=2)
    params, model = _pair(cfg, 0)
    jdraft, tdraft = _pair(dcfg, 1)
    _assert_spec_greedy(cfg, params, model, jdraft, tdraft, dcfg, k=3,
                        inputs=dict(labels=np.arange(3)), cfg_scale=1.5,
                        cache=(jnp.int8, torch.int8), draft_cache=(jnp.bfloat16, torch.bfloat16))


def test_spec_greedy_t2i_emb_masks():
    cfg = GPTConfig(model_type="t2i", dim=64, n_layer=2, n_head=4, cls_token_num=6,
                    block_size=16, vocab_size=64, caption_dim=48)
    params, model = _pair(cfg, 2)
    jq = jquant.quantize_gpt_params(params)
    tq = convert.gpt_from_jax(_np_tree(jq), _tcfg(cfg))
    rng = np.random.default_rng(0)
    inputs = dict(caption_emb=rng.standard_normal((2, 6, 48)).astype(np.float32),
                  emb_masks=np.array([[0, 0, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1]], np.int32),
                  adapter_features=rng.standard_normal((2, 16, cfg.adapter_dim)).astype(
                      np.float32))
    _assert_spec_greedy(cfg, params, model, jq, tq, k=4, inputs=inputs, cfg_scale=3.0,
                        control_strength=0.7)


def test_spec_greedy_w4_self_draft():
    """The W4 draft of the JAX pipeline's spec_draft="w4" (no split rope)."""
    cfg = _c2i_cfg(dim=128, n_head=2)
    params, model = _pair(cfg, 3)
    jw4 = jquant.quantize_gpt_params_w4(jdec.unstack_layers(params))
    tw4 = convert.gpt_from_jax(_np_tree(jw4), _tcfg(cfg))
    _assert_spec_greedy(cfg, params, model, jw4, tw4, k=4, inputs=dict(labels=np.arange(2)),
                        cfg_scale=2.0)


def test_topk1_sampling_equals_greedy():
    """top_k = 1 collapses the warped distributions to the argmax: sampling
    emits the greedy tokens, whatever the draft."""
    cfg = _c2i_cfg(n_layer=2)
    tcfg = _tcfg(cfg)
    model = tgpt.init_gpt(tcfg, seed=0)
    draft = tgpt.init_gpt(tcfg, seed=4)
    kw = dict(labels=torch.arange(4), max_new_tokens=12, k_draft=3, cfg_scale=2.0,
              device="cpu")
    greedy = tspec.generate_spec(model, tcfg, draft, **kw)
    sampled = tspec.generate_spec(model, tcfg, draft, seed=7, top_k=1, **kw)
    assert torch.equal(sampled, greedy)


def test_sampling_with_an_equal_self_draft_accepts_every_draft():
    """p == q at every position: every draft is accepted (k per cycle), and
    another seed gives other tokens."""
    cfg = _c2i_cfg(n_layer=2)
    tcfg = _tcfg(cfg)
    model = tgpt.init_gpt(tcfg, seed=2)
    kw = dict(labels=torch.arange(4), max_new_tokens=12, k_draft=3, device="cpu")
    toks, stats = tspec.generate_spec(model, tcfg, model, seed=3, return_stats=True, **kw)
    assert toks.shape == (4, 12) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert stats["accepted_per_cycle"] == 3.0
    assert not torch.equal(tspec.generate_spec(model, tcfg, model, seed=4, **kw), toks)


def test_generate_spec_refuses_the_plain_route_on_a_card_device_only():
    cfg = _c2i_cfg(n_layer=1)
    model = tgpt.init_gpt(_tcfg(cfg), seed=0)
    out = tspec.generate_spec(model, _tcfg(cfg), model, labels=torch.arange(1), max_new_tokens=4,
                              use_flash=False, device="cpu")
    assert out.shape == (1, 4)


# ---- the pipeline -----------------------------------------------------------------

def _pipeline(with_draft):
    cfg = TGPTConfig(model_type="c2i", dim=128, n_layer=2, n_head=2, cls_token_num=1,
                     block_size=4, vocab_size=32, num_classes=5)
    vcfg = TVQConfig(codebook_size=32, z_channels=8, ch=8, decoder_ch_mult=(1, 1))
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, pos_grid=2)
    kw = {}
    if with_draft:
        dcfg = TGPTConfig(model_type="c2i", dim=128, n_layer=1, n_head=2, cls_token_num=1,
                          block_size=4, vocab_size=32, num_classes=5)
        kw = dict(draft_gpt_cfg=dcfg, draft_gpt=tgpt.init_gpt(dcfg, seed=9))
    return ControlARPipeline(gpt_cfg=cfg, gpt=tgpt.init_gpt(cfg, seed=0), vq_cfg=vcfg,
                             vq=tvq.init_vq(vcfg, seed=1), adapter_cfg=acfg,
                             adapter=tvit.init_vit(acfg, seed=2), device="cpu", **kw)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_pipeline_spec_drafts_equal_greedy_and_leave_the_models_unchanged():
    """top_k = 1: the plain sampler and every spec_draft mode emit the same
    greedy images; a quantized draft is a copy, so the GPT and draft_gpt
    keep their weights and modules."""
    pipe = _pipeline(with_draft=True)
    gpt_before, draft_before = _state(pipe.gpt), _state(pipe.draft_gpt)
    img = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    kw = dict(labels=np.array([1, 2]), condition_images=img, cfg_scale=2.0, top_k=1)
    ref = pipe.generate(**kw)
    for mode in ("int8", "w4", "model", "model-int8"):
        stats = {}
        out = pipe.generate(**kw, spec_draft=mode, spec_stats=stats)
        np.testing.assert_array_equal(out, ref, err_msg=mode)
        assert 1.0 <= stats["accepted_per_cycle"] <= 4 and stats["loop_iters"] >= 1
    for before, module in ((gpt_before, pipe.gpt), (draft_before, pipe.draft_gpt)):
        after = module.state_dict()
        assert after.keys() == before.keys()
        assert all(torch.equal(after[k], v) for k, v in before.items())
    assert isinstance(pipe.gpt.layers[0].wqkv, torch.nn.Linear)
    sampled = pipe.generate(labels=np.array([1, 2]), cfg_scale=2.0, top_k=0, spec_draft="model")
    assert sampled.shape == ref.shape


def test_pipeline_spec_draft_model_needs_a_draft():
    pipe = _pipeline(with_draft=False)
    with pytest.raises(ValueError, match="draft_gpt"):
        pipe.generate(labels=np.array([1]), spec_draft="model")
    with pytest.raises(ValueError, match="spec_draft"):
        pipe.generate(labels=np.array([1]), spec_draft="int4")
