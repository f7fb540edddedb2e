"""The port's quantizers and quantized modules against the JAX package's
(CPU). Quantizers and converted carriers must be bit-exact: both packages
round the same fp32 quotients half to even."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import quant as jquant
from controlar_tpu.config import GPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.ops import rope as jrope
from controlar_tpu.ops import w4_matmul as jw4
from controlar_tpu_torch import convert
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch import quant as tquant
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.ops import rope as trope
from controlar_tpu_torch.ops import w4_matmul as tw4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(200, 96), (2, 64, 48)])
def test_quantize_weight_bit_exact(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jquant.quantize_weight(jnp.asarray(w))
    q, s = tquant.quantize_weight(_t(w))
    _eq(q, want["q"])
    _eq(s, want["s"])
    _eq(tquant.dequantize_weight(q, s, torch.float32),
        jquant.dequantize_weight(want, jnp.float32))


# planes: 256 -> 2, 384 -> 3 (odd), 3200 -> 25 (odd, GPT-3B), 200 -> padded K
@pytest.mark.parametrize("k", [256, 384, 3200, 200])
def test_quantize_weight_w4_bit_exact(k):
    w = np.random.default_rng(k).standard_normal((k, 64)).astype(np.float32)
    want = jw4.quantize_weight_w4(jnp.asarray(w))
    q4, s = tw4.quantize_weight_w4(_t(w))
    _eq(q4, want["q4"])
    _eq(s, want["s"])
    _eq(tw4.dequantize_weight_w4(q4, s, torch.float32, k=k),
        jw4.dequantize_weight_w4(want, jnp.float32, k=k))


def test_quantize_kv_rows_bit_exact():
    kv = np.random.default_rng(1).standard_normal((2, 3, 2 * 4 * 10)).astype(np.float32)
    want_q, want_s = jquant.quantize_kv_rows(jnp.asarray(kv), 4)
    q, s = tquant.quantize_kv_rows(_t(kv), 4)
    _eq(q, want_q)
    _eq(s, want_s)
    _eq(tquant.dequantize_kv_slab(q, s, 4), jquant.dequantize_kv_slab(want_q, want_s, 4))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("h,d", [(4, 10), (2, 64), (3, 100)])
def test_quantize_kv_rows_4_bit_exact(split, h, d):
    """The port's rows are the JAX package's without its 128-byte lane
    padding of each half."""
    kv = np.random.default_rng(d).standard_normal((2, 3, 2 * h * d)).astype(np.float32)
    want_c, want_s = jquant.quantize_kv_rows_4(jnp.asarray(kv), h, split=split)
    c, s = tquant.quantize_kv_rows_4(_t(kv), h, split=split)
    half = h * d // 2
    _eq(c, np.asarray(want_c).reshape(2, 3, 2, -1)[..., :half].reshape(2, 3, -1))
    _eq(s, want_s)
    _eq(tquant.dequantize_kv4_slab(c, s, h, d, split=split),
        jquant.dequantize_kv4_slab(want_c, want_s, h, d, split=split))


def _cfg_pair(model_type="c2i", **over):
    kw = dict(model_type=model_type, dim=256, n_layer=3, n_head=4, vocab_size=96,
              num_classes=10, caption_dim=24, cls_token_num=1 if model_type == "c2i" else 6,
              block_size=16)
    kw.update(over)
    return GPTConfig(**kw), TGPTConfig(**kw)


def _params(cfg):
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)
    # the t2i head is zero at init; give it weights so greedy tokens vary
    params["output"] = jax.random.normal(jax.random.PRNGKey(1), params["output"].shape) * 0.5
    return params


def test_split_head_perm_and_rope_tables_bit_exact():
    for nh, nkv, d in [(4, 4, 64), (3, 1, 10)]:
        for got, want in zip(tquant.split_head_perm(nh, nkv, d),
                             jquant.split_head_perm(nh, nkv, d)):
            np.testing.assert_array_equal(got, want)
    table = jrope.precompute_rope_2d(4, 16, 10000.0, 1)
    jc, js = jrope.make_split_rope_tables(jnp.asarray(table), 2, 2, 16)
    tc, ts = trope.make_split_rope_tables(_t(table), 2, 2, 16)
    _eq(tc, jc)
    _eq(ts, js)
    x = np.random.default_rng(2).standard_normal((2, 17, 64)).astype(np.float32)
    _eq(trope.apply_rope_split(_t(x), tc[None], ts[None], 16),
        jrope.apply_rope_split(jnp.asarray(x), jc[None], js[None], 16))


@pytest.mark.parametrize("w8", [False, True])
def test_to_split_rope_matches_jax(w8):
    cfg, tcfg = _cfg_pair()
    params = jdec.unstack_layers(_params(cfg))
    if w8:
        params = jquant.quantize_gpt_params(params)
    want = convert.gpt_from_jax(_np_tree(jquant.to_split_rope(params, cfg)), tcfg)
    got = tquant.to_split_rope(convert.gpt_from_jax(_np_tree(params), tcfg), tcfg)
    assert tquant.is_split(got) and tquant.is_split(want)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert sorted(sd_got) == sorted(sd_want)
    for key in sd_want:
        assert torch.equal(sd_got[key], sd_want[key]), key


CONVERT_CASES = {
    "int8_stacked": dict(mode="int8", unstack=False, keep=()),
    "int8_keep_head": dict(mode="int8", unstack=True, keep=("output",)),
    "w4_split": dict(mode="w4", unstack=True, keep=(), split=True),
    "w4_keep_w2": dict(mode="w4", unstack=True, keep=("w2",), split=False),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_convert_quantized_tree_equals_own_quantize(case):
    """gpt_from_jax of a JAX-quantized tree holds the same carriers and
    scales as the port's quantize_gpt of the converted float model."""
    c = CONVERT_CASES[case]
    cfg, tcfg = _cfg_pair()
    params = _params(cfg)
    if c["unstack"]:
        params = jdec.unstack_layers(params)
    if c["mode"] == "int8":
        jq = jquant.quantize_gpt_params(params, keep=c["keep"])
    else:
        jq = jquant.quantize_gpt_params_w4(params, keep=c["keep"],
                                           cfg=cfg if c["split"] else None)
    got = convert.gpt_from_jax(_np_tree(jq), tcfg)
    own = tquant.quantize_gpt(convert.gpt_from_jax(_np_tree(params), tcfg), tcfg,
                              mode=c["mode"], keep=c["keep"], split_rope=c.get("split", False))
    sd_got, sd_own = got.state_dict(), own.state_dict()
    assert sorted(sd_got) == sorted(sd_own)
    for key in sd_own:
        assert sd_got[key].dtype == sd_own[key].dtype and torch.equal(sd_got[key], sd_own[key]), key
    lp = got.layers[0]
    if c["mode"] == "w4":
        assert isinstance(got.output, tquant.W8Linear)
        if "w2" in c["keep"]:
            assert isinstance(lp.w2, torch.nn.Linear) and isinstance(lp.w13, tquant.W4Linear)
        else:
            assert not hasattr(lp, "w1")
            assert isinstance(lp.w13, tquant.W4Linear) and isinstance(lp.w2, tquant.W4Linear)
            _eq(lp.w13.q4, jq["layers"][0]["w13"]["q4"])
    else:
        assert isinstance(lp.wqkv, tquant.W8Linear)
        assert isinstance(got.output, torch.nn.Linear) == ("output" in c["keep"])


def test_quantized_caches_layout():
    _, tcfg = _cfg_pair(n_kv_head=2)
    c8 = tdec.init_flat_caches(tcfg, 3, 16, torch.int8)
    c4 = tdec.init_flat_caches(tcfg, 3, 16, "int4")
    assert len(c8) == tcfg.n_layer and c8[0]["kv"].shape == (3, 16, 2 * 2 * 64)
    assert c4[0]["kv4"].shape == (3, 16, 2 * 64) and c4[0]["s"].shape == (3, 16, 4)
    assert tdec.cache_seq_len(c4) == 16
    with pytest.raises(ValueError):
        tdec.init_flat_caches(tcfg, 3, 16, torch.int32)


def test_w4_linear_on_the_cpu_is_the_dequantized_matmul():
    """On the CPU the W4 module takes the JAX package's fallback (bf16
    dequantized weight, one matmul) and launches nothing."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((384, 128)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 5, 384)).astype(np.float32)
    mod = tquant.W4Linear.from_weight(_t(w))
    before = tw4.w4_matmul.launches
    got = mod(_t(x))
    assert tw4.w4_matmul.launches == before and got.shape == (2, 5, 128)
    want = jquant.wdot(jnp.asarray(x), jw4.quantize_weight_w4(jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    w8 = tquant.W8Linear.from_weight(_t(w))
    want8 = jquant.wdot(jnp.asarray(x), jquant.quantize_weight(jnp.asarray(w)))
    np.testing.assert_allclose(w8(_t(x)).numpy(), np.asarray(want8), rtol=1e-6, atol=1e-6)
