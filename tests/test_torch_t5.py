"""The port's T5 encoder, its converters and loader, and the T5 embedder
against the JAX package's `models/t5.py`, `convert/torch_t5.py` and
`text/embedder.py`, on the CPU, at tests/test_t5.py's tiny configuration
(vocab 256, d 64, d_kv 16, FFN 128, 3 layers, 4 heads).

Tolerances: fp32 outputs within 3e-5 absolute (tests/test_t5.py's limit
against HF; values O(1) after the final norm, summed in another order);
bf16 outputs within two bf16 steps at the outputs' size (|x| < 4: 2 * 2**-6
absolute); weights read through either converter or the
loader bit for bit; greedy t2i tokens equal.

The HF models (and `transformers`, which the port itself never imports) are
used only to write checkpoints in HF's layouts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu import generate as jgen
from controlar_tpu.config import GPTConfig
from controlar_tpu.convert.torch_t5 import convert_t5_state_dict
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import t5 as jt5
from controlar_tpu_torch import cells, checkpoint, convert, convert_ref
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.models import t5 as tt5
from controlar_tpu_torch.text.cleaning import text_preprocess
from controlar_tpu_torch.text.embedder import T5Embedder
from tests.port_data_helpers import T5_TINY, jax_t5_embedder, tiny_t5_params

ATOL = 3e-5
BF16_ATOL = 2 * 2 ** -6  # two bf16 steps at 2 <= |x| < 4
JCFG, TCFG = jt5.T5Config(**T5_TINY), tt5.T5Config(**T5_TINY)


def _ids(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (b, t)).astype(np.int64)


MASKS = {  # name -> (B, 24) mask
    "full": np.ones((2, 24), np.int64),
    "right_padded": np.array([[1] * 17 + [0] * 7, [1] * 5 + [0] * 19]),
    "all_zero_row": np.array([[1] * 24, [0] * 24]),
}


def _jax_encode(params, ids, mask, dtype=jnp.float32):
    p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    return np.asarray(jax.jit(jt5.t5_encode, static_argnums=1)(
        p, JCFG, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))


@pytest.mark.parametrize("q_len,k_len", [(7, 7), (24, 24), (120, 120), (300, 200)])
def test_relative_position_bucket_matches_jax(q_len, k_len):
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel, 32, 128),
                                  jt5._relative_position_bucket(rel, 32, 128))


@pytest.mark.parametrize("mask", list(MASKS))
def test_t5_encode_matches_jax(mask):
    params = tiny_t5_params()
    ids, m = _ids(2, 24), MASKS[mask]
    want = _jax_encode(params, ids, m)
    model = convert.t5_from_jax(params, TCFG)
    got = tt5.t5_encode(model, TCFG, torch.from_numpy(ids), torch.from_numpy(m))
    assert got.shape == (2, 24, 64) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(model(torch.from_numpy(ids), torch.from_numpy(m)).numpy(), want,
                               atol=ATOL)


def test_t5_encode_bf16_matches_jax():
    params = tiny_t5_params()
    ids, m = _ids(2, 24), MASKS["right_padded"]
    want = _jax_encode(params, ids, m, jnp.bfloat16)
    model = convert.t5_from_jax(params, TCFG, dtype=torch.bfloat16)
    got = tt5.t5_encode(model, TCFG, torch.from_numpy(ids), torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_init_t5_is_seeded():
    a = tt5.init_t5(TCFG, seed=3, device="cpu").state_dict()
    b = tt5.init_t5(TCFG, seed=3, device="cpu").state_dict()
    c = tt5.init_t5(TCFG, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.q.weight"], c["layers.0.q.weight"])
    assert torch.equal(a["layers.2.ln2"], torch.ones(64))
    assert abs(float(a["embedding.weight"].std()) - 0.02) < 2e-3


# --- HF layouts ---------------------------------------------------------------


def _hf_config(**over):
    from transformers import T5Config as HFT5Config

    kw = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=3, num_heads=4,
              relative_attention_num_buckets=32, relative_attention_max_distance=128,
              dropout_rate=0.0, feed_forward_proj="gated-gelu", is_encoder_decoder=False,
              use_cache=False, tie_word_embeddings=False)
    kw.update(over)
    return HFT5Config(**kw)


@pytest.fixture(scope="module")
def hf_encoder():
    pytest.importorskip("transformers")
    from transformers import T5EncoderModel

    torch.manual_seed(0)
    return T5EncoderModel(_hf_config()).float().eval()


def _jax_tree_as_port(sd):
    """The JAX converter's tree of an HF state dict, in the port's names and
    layout (linears (out, in))."""
    tree = convert_t5_state_dict(sd, JCFG)
    return convert.t5_from_jax(tree, TCFG).state_dict()


def _assert_same_weights(model, sd):
    want = _jax_tree_as_port(sd)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_t5_from_state_dict_matches_the_jax_converter(hf_encoder):
    sd = hf_encoder.state_dict()
    model = convert_ref.t5_from_state_dict(sd, TCFG, device="cpu")
    _assert_same_weights(model, sd)
    back = convert_ref.t5_hf_state_dict(model)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_t5_encode_matches_hf(hf_encoder):
    model = convert_ref.t5_from_state_dict(hf_encoder.state_dict(), TCFG, device="cpu")
    ids, m = _ids(2, 24), MASKS["right_padded"]
    with torch.no_grad():
        want = hf_encoder(input_ids=torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(m)).last_hidden_state.numpy()
    got = tt5.t5_encode(model, TCFG, torch.from_numpy(ids), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _save(tmp_path, fmt):
    """An HF checkout of `fmt`: one model.safetensors, shards with an index,
    a pytorch_model.bin, or a seq2seq (encoder and decoder) safetensors."""
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(0)
    if fmt == "seq2seq":
        model = T5ForConditionalGeneration(_hf_config(is_encoder_decoder=True,
                                                      num_decoder_layers=2))
    else:
        from transformers import T5EncoderModel

        model = T5EncoderModel(_hf_config())
    kw = {"sharded": dict(max_shard_size="100KB"), "bin": dict(safe_serialization=False)}
    model.save_pretrained(str(tmp_path), **kw.get(fmt, {}))
    return model.eval().state_dict()


@pytest.mark.parametrize("fmt", ["safetensors", "sharded", "bin", "seq2seq"])
def test_load_t5_encoder(tmp_path, fmt):
    pytest.importorskip("transformers")
    sd = _save(tmp_path, fmt)
    model = checkpoint.load_t5_encoder(str(tmp_path), TCFG, device="cpu")
    _assert_same_weights(model, {k: v for k, v in sd.items()
                                 if k == "shared.weight" or k.startswith("encoder.")})
    bf = checkpoint.load_t5_encoder(str(tmp_path), TCFG, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


def test_load_safetensors_reads_only_the_kept_tensors(tmp_path):
    pytest.importorskip("transformers")
    sd = _save(tmp_path, "seq2seq")
    path = str(tmp_path / "model.safetensors")
    full = checkpoint.load_safetensors(path)
    assert any(k.startswith("decoder.") for k in full)
    part = checkpoint.load_safetensors(path, keep=lambda k: k.startswith("encoder."))
    assert part and set(part) == {k for k in full if k.startswith("encoder.")}
    for k, v in part.items():
        assert torch.equal(v, full[k]) and torch.equal(v, sd[k])


# --- the embedder -------------------------------------------------------------

MAX_LEN = 12
TEXTS = ["A <b>red</b> house by the river", "two dogs &amp; a cat on the beach at night "
         "under bright clouds with many small boats", "", "  SNOW  "]


def _jax_embedder(params):
    return jax_t5_embedder(params, MAX_LEN)


def _port_embedder(params):
    return T5Embedder(convert.t5_from_jax(params, TCFG), cells.word_tokenizer(TCFG.vocab_size),
                      TCFG, model_max_length=MAX_LEN, device="cpu")


def test_embedder_matches_jax():
    params = tiny_t5_params()
    want_emb, want_mask = _jax_embedder(params).get_text_embeddings(TEXTS)
    got_emb, got_mask = _port_embedder(params).get_text_embeddings(TEXTS)
    assert got_emb.shape == (4, MAX_LEN, 64) and got_emb.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert want_mask.sum(1).tolist()[2] == 1  # the empty caption is EOS alone
    np.testing.assert_allclose(got_emb.numpy(), want_emb, atol=ATOL)


def test_embedder_encode_takes_token_ids():
    params = tiny_t5_params()
    emb = _port_embedder(params)
    ids, mask = cells.caption_token_ids(3, seed=5, vocab_size=TCFG.vocab_size, length=MAX_LEN)
    got, m = emb.encode(ids, mask)
    np.testing.assert_array_equal(m.numpy(), mask)
    np.testing.assert_allclose(got.numpy(), _jax_encode(params, ids, mask), atol=ATOL)
    with pytest.raises(ValueError, match="tokenizer"):
        T5Embedder(emb.model, None, TCFG, device="cpu").get_text_embeddings(["x"])


def test_embedder_from_pretrained(tmp_path):
    pytest.importorskip("transformers")
    sd = _save(tmp_path, "safetensors")
    emb = T5Embedder.from_pretrained(str(tmp_path), cells.word_tokenizer(TCFG.vocab_size),
                                     TCFG, device="cpu", model_max_length=MAX_LEN)
    assert all(p.dtype == torch.bfloat16 for p in emb.model.parameters())
    got, _ = emb.get_text_embeddings(TEXTS[:2])
    model = convert_ref.t5_from_state_dict(sd, TCFG, torch.bfloat16, device="cpu")
    ids, mask = cells.word_tokenizer(TCFG.vocab_size)([text_preprocess(t) for t in TEXTS[:2]],
                                                      MAX_LEN)
    want = tt5.t5_encode(model, TCFG, torch.from_numpy(ids), torch.from_numpy(mask)).float()
    assert torch.equal(got, want)


# --- captions -> t2i generation ------------------------------------------------


@pytest.mark.parametrize("cfg_scale", [7.5, 1.0])
def test_captions_to_t2i_greedy_tokens_match_jax(cfg_scale):
    """Captions -> T5 -> t2i generate, as the JAX CLI's sample-t2i passes the
    embedder's right-padded features and mask; greedy tokens equal."""
    params = tiny_t5_params()
    kw = dict(model_type="t2i", dim=64, n_layer=4, n_head=4, vocab_size=96, num_classes=10,
              caption_dim=64, adapter_size="small", cls_token_num=MAX_LEN, block_size=16)
    gcfg = GPTConfig(**kw)
    gparams = jgpt.init_gpt_params(jax.random.PRNGKey(0), gcfg)
    gparams["output"] = jax.random.normal(jax.random.PRNGKey(1), gparams["output"].shape)
    model = convert.gpt_from_jax(jax.tree.map(np.asarray, gparams), TGPTConfig(**kw))
    jemb, jmask = _jax_embedder(params).get_text_embeddings(TEXTS)
    temb, tmask = _port_embedder(params).get_text_embeddings(TEXTS)
    want = jgen.generate(gparams, gcfg, caption_emb=jnp.asarray(jemb),
                         emb_masks=jnp.asarray(jmask), max_new_tokens=16, sample_logits=False,
                         top_k=20, cfg_scale=cfg_scale)
    got = tgen.generate(model, TGPTConfig(**kw), caption_emb=temb, emb_masks=tmask,
                        max_new_tokens=16, sample_logits=False, top_k=20, cfg_scale=cfg_scale,
                        device="cpu")
    assert len(np.unique(np.asarray(want))) > 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
