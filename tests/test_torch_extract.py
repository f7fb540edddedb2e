"""The port's extraction (`data/extract.py`) against the JAX package's, on the
CPU: the same images, captions and weights (VQ, a tiny T5, a tiny MiDaS)
through both packages' extract_tree / extract_c2i_tree, the written trees
compared file by file.

Tolerances: codes equal, or a tie under tests/test_torch_vq_encoder.py's
rule (where indices differ, the two codes' fp32 distances to the encoder
output agree within 1e-5); caption features within 1e-5 (a fp32 T5 of 3
layers, summed in another order); images, labels, controls, Canny maps
and prompts equal; MiDaS depth maps within 1 (uint8 truncations of 0..255
values that agree within 5e-3, test_torch_depth.py's limit).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controlar_tpu.config import VQConfig
from controlar_tpu.data import extract as jext
from controlar_tpu.models import midas as jmidas
from controlar_tpu_torch import cells, convert
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.data import extract as text
from controlar_tpu_torch.models import midas as tmidas
from controlar_tpu_torch.models import t5 as tt5
from controlar_tpu_torch.models import vq as tvq
from controlar_tpu_torch.text.embedder import T5Embedder
from tests.port_data_helpers import T5_TINY, jax_t5_embedder, random_vq_params, tiny_t5_params

TIE = 1e-5
EMB_ATOL = 1e-5
VQ_KW = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16,
             encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2))
MIDAS_KW = dict(stem_width=32, layers=(1, 1, 1), hidden_size=64, n_layer=3, n_head=2,
                mlp_dim=128, pos_grid=4, vit_hooks=(1, 2), features=32,
                layer_channels=(256, 512, 64, 64))
MAX_LEN = 12


@pytest.fixture(scope="module")
def models():
    """(JAX VQ params, JAX cfg, port VQ, port cfg, JAX embedder, port
    embedder), fp32, the same weights."""
    cfg, tcfg = VQConfig(**VQ_KW), TVQConfig(**VQ_KW)
    vq_np = random_vq_params(cfg)
    t5_np = tiny_t5_params()
    tcfg5 = tt5.T5Config(**T5_TINY)
    temb = T5Embedder(convert.t5_from_jax(t5_np, tcfg5), cells.word_tokenizer(tcfg5.vocab_size),
                      tcfg5, model_max_length=MAX_LEN, device="cpu")
    return (jax.tree.map(jnp.asarray, vq_np), cfg, convert.vq_from_jax(vq_np, tcfg), tcfg,
            jax_t5_embedder(t5_np, MAX_LEN), temb)


def _samples(n, px, seed=0):
    rng = np.random.default_rng(seed)
    caps = cells.caption_texts(n, seed)
    return [{"image": rng.integers(0, 255, (px + 10, px + 4, 3)).astype(np.uint8),
             "caption": caps[i] if i != 2 else None,
             "control": rng.integers(0, 255, (px, px, 3)).astype(np.uint8),
             "label": rng.integers(0, 20, (px, px)).astype(np.uint8)} for i in range(n)]


def _check_codes(got, want, image, tvq_model, tcfg):
    """Codes equal, or ties: the codes' distances to the encoder output of
    the saved image (normalised) within TIE. Returns the number of ties."""
    differ = got != want
    if differ.any():
        x = torch.as_tensor(image, dtype=torch.float32)[None] / 127.5 - 1.0
        with torch.no_grad():
            z = tvq._conv(tvq_model.quant_conv, tvq.encoder_forward(tvq_model.encoder, tcfg,
                                                                      x))[0].numpy()
        emb = tvq._codebook(tvq_model, tcfg).detach().numpy()
        zn = z[differ] / np.linalg.norm(z[differ], axis=-1, keepdims=True)
        d = (zn * zn).sum(-1, keepdims=True) + (emb * emb).sum(-1) - 2 * zn @ emb.T
        rows = np.arange(len(zn))
        assert np.abs(d[rows, got[differ]] - d[rows, want[differ]]).max() <= TIE
    return int(differ.sum())


def _png(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("rank,count", [(0, 1), (1, 3)])
def test_extract_tree_matches_jax(models, tmp_path, rank, count):
    jvq_params, cfg, tvq_model, tcfg, jemb, temb = models
    px, n = 32, 5
    kw = dict(image_size=px, process_index=rank, process_count=count, batch_images=2)
    assert jext.extract_tree(str(tmp_path / "jax"), _samples(n, px), jvq_params, cfg,
                             t5_embedder=jemb, **kw) == n
    assert text.extract_tree(str(tmp_path / "port"), _samples(n, px), tvq_model, tcfg,
                             t5_embedder=temb, device="cpu", **kw) == n
    names = sorted(f"{rank + count * i}" for i in range(n))
    for sub in ("code", "image", "control", "label"):
        ext = ".npy" if sub == "code" else ".png"
        assert sorted(os.listdir(tmp_path / "port" / sub)) == sorted(
            os.listdir(tmp_path / "jax" / sub)) == sorted(f"{i}{ext}" for i in names)
    assert sorted(os.listdir(tmp_path / "port" / "caption_emb")) == sorted(
        f"{rank + count * i}.npz" for i in range(n) if i != 2)
    for i in names:
        img = _png(tmp_path / "port" / "image" / f"{i}.png")
        np.testing.assert_array_equal(img, _png(tmp_path / "jax" / "image" / f"{i}.png"))
        for sub in ("control", "label"):
            np.testing.assert_array_equal(_png(tmp_path / "port" / sub / f"{i}.png"),
                                          _png(tmp_path / "jax" / sub / f"{i}.png"))
        got = np.load(tmp_path / "port" / "code" / f"{i}.npy")
        want = np.load(tmp_path / "jax" / "code" / f"{i}.npy")
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == (8, 8)
        _check_codes(got, want, img, tvq_model, tcfg)
        cap = tmp_path / "port" / "caption_emb" / f"{i}.npz"
        if cap.exists():
            g, w = np.load(cap), np.load(tmp_path / "jax" / "caption_emb" / f"{i}.npz")
            assert g["caption_emb"].shape == w["caption_emb"].shape
            assert g["caption_emb"].shape[1] < MAX_LEN + 1 and g["caption_emb"].dtype == np.float32
            np.testing.assert_allclose(g["caption_emb"], w["caption_emb"], atol=EMB_ATOL)
            assert g["prompt"].tolist() == w["prompt"].tolist()


def test_extract_tree_codes_equal_a_direct_encode(models, tmp_path):
    """The stored codes are the VQ encode of the saved image."""
    _, _, tvq_model, tcfg, _, _ = models
    text.extract_tree(str(tmp_path), _samples(3, 32), tvq_model, tcfg, image_size=32,
                      device="cpu")
    for i in range(3):
        img = _png(tmp_path / "image" / f"{i}.png")
        x = torch.as_tensor(img, dtype=torch.float32)[None] / 127.5 - 1.0
        with torch.no_grad():
            _, idx = tvq.encode(tvq_model, tcfg, x, device="cpu")
        np.testing.assert_array_equal(np.load(tmp_path / "code" / f"{i}.npy"), idx[0].numpy())
    assert os.listdir(tmp_path / "caption_emb") == []


@pytest.fixture(scope="module")
def midas_pair():
    cfg = jmidas.MidasHybridConfig(**MIDAS_KW)
    params = jax.jit(jmidas.init_midas_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)  # non-trivial norms and biases
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
        np.float32), params)
    tcfg = tmidas.MidasHybridConfig(**MIDAS_KW)
    return jax.tree.map(jnp.asarray, params), cfg, convert.midas_from_jax(params, tcfg), tcfg


@pytest.mark.parametrize("ten_crop,conditions", [(False, ("canny",)),
                                                 (True, ("canny", "depth"))])
def test_extract_c2i_tree_matches_jax(models, midas_pair, tmp_path, ten_crop, conditions):
    jvq_params, cfg, tvq_model, tcfg, _, _ = models
    jmid, jmcfg, tmid, tmcfg = midas_pair
    px, n = 64, 3
    rng = np.random.default_rng(4)
    samples = [{"image": rng.integers(0, 255, (px + 14, px + 20, 3)).astype(np.uint8),
                "label": 100 + i} for i in range(n)]
    kw = dict(image_size=px, use_ten_crop=ten_crop, conditions=conditions, batch_images=2,
              process_index=1, process_count=2)
    assert jext.extract_c2i_tree(str(tmp_path / "jax"), samples, jvq_params, cfg,
                                 depth_params=jmid, depth_cfg=jmcfg, **kw) == n
    assert text.extract_c2i_tree(str(tmp_path / "port"), samples, tvq_model, tcfg, midas=tmid,
                                 midas_cfg=tmcfg, device="cpu", **kw) == n
    a = 10 if ten_crop else 2
    crops = [text.c2i_crops(s["image"], px, ten_crop) for s in samples]
    for j, i in enumerate((1, 3, 5)):
        pre = {k: tmp_path / k / f"imagenet{px}" for k in ("port", "jax")}
        got = np.load(f"{pre['port']}_codes/{i}.npy")
        want = np.load(f"{pre['jax']}_codes/{i}.npy")
        assert got.dtype == want.dtype == np.int64 and got.shape == want.shape == (1, a, 256)
        for c in range(a):
            _check_codes(got[0, c].reshape(16, 16), want[0, c].reshape(16, 16), crops[j][c],
                         tvq_model, tcfg)
        np.testing.assert_array_equal(np.load(f"{pre['port']}_labels/{i}.npy"),
                                      np.load(f"{pre['jax']}_labels/{i}.npy"))
        for cond in conditions:
            g = np.load(f"{pre['port']}_{cond}_imagesnpy/{i}.npy")
            w = np.load(f"{pre['jax']}_{cond}_imagesnpy/{i}.npy")
            assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape == (a, 1, px, px)
            diff = np.abs(g.astype(int) - w.astype(int)).max()
            assert diff == 0 if cond == "canny" else diff <= 1, (cond, diff)
            np.testing.assert_array_equal(_png(f"{pre['port']}_{cond}_images/{i}.png"), g[0, 0])


def test_extract_c2i_tree_needs_midas_for_depth(models, tmp_path):
    _, _, tvq_model, tcfg, _, _ = models
    with pytest.raises(ValueError, match="MiDaS"):
        text.extract_c2i_tree(str(tmp_path), [], tvq_model, tcfg, conditions=("depth",),
                              device="cpu")


@pytest.mark.parametrize("use_ten_crop", [False, True])
def test_crops_match_jax(use_ten_crop):
    img = np.random.default_rng(5).integers(0, 255, (50, 61, 3)).astype(np.uint8)
    np.testing.assert_array_equal(text.c2i_crops(img, 32, use_ten_crop),
                                  jext.c2i_crops(img, 32, use_ten_crop))
    arr = img[:40, :48]
    np.testing.assert_array_equal(text.ten_crop(arr, 32), jext.ten_crop(arr, 32))
    with pytest.raises(ValueError):
        text.ten_crop(arr, 64)
