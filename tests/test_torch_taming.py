"""The port's taming VQGAN (the comparison tokenizers) against the JAX
package's `models/taming_vqgan.py`, fp32 on the CPU, the weights carried
over by `convert.taming_from_jax`; its checkpoint loaders; and the SD-VAE /
consistency-decoder wrappers without diffusers.

Every `TAMING_CONFIGS` entry at a narrow width (ch 16, 32 px, a 64-entry
codebook drawn normal as a trained one is spread; attention at the
config's lowest resolution and at one more level), each level's structure
the config's. Tolerances: the encoder's latent and z_q 1e-5 of their
largest, the loss 1e-5 relative; the codes equal, or at a tie (the two
codes' JAX distances within 1e-5 of each other); decode and decode_code
1e-4 of the image's largest. Remap: "extra" and an int give the JAX
package's ids; "random" (a torch.Generator, not jax.random) only its range
and the known ids. The loaders bit for bit.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.convert.torch_taming import convert_taming_state_dict, load_taming_checkpoint
from controlar_tpu.models import taming_vqgan as jt
from controlar_tpu_torch import checkpoint, convert, convert_ref
from controlar_tpu_torch.models import latent_vae
from controlar_tpu_torch.models import taming_vqgan as tt

LATENT_TOL, IMAGE_TOL, LOSS_RTOL, TIE = 1e-5, 1e-4, 1e-5, 1e-5
PX = 32


def _narrow(name):
    """The config at ch 16 and 32 px: attention at the lowest resolution
    (as the released config) and at twice it."""
    cfg = jt.TAMING_CONFIGS[name]
    low = PX // 2 ** (cfg.num_resolutions - 1)
    return dataclasses.replace(cfg, ch=16, resolution=PX, attn_resolutions=(low, 2 * low),
                               n_embed=64, embed_dim=min(cfg.embed_dim, 16),
                               z_channels=min(cfg.z_channels, 16))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX config, JAX tree, port config, port model)."""
    jc = _narrow(name)
    params = jax.tree.map(np.asarray, jt.init_taming_params(jax.random.PRNGKey(0), jc))
    params["embedding"] = np.random.default_rng(1).standard_normal(
        params["embedding"].shape).astype(np.float32)
    tc = tt.TamingVQConfig(**dataclasses.asdict(jc))
    return jc, params, tc, convert.taming_from_jax(params, tc)


def _x(seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= tol * np.abs(want).max()


def _codes_or_ties(params, z, got, want):
    """Codes equal, or the two codes' JAX distances within TIE."""
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    emb = params["embedding"].astype(np.float64)
    flat = np.asarray(z, np.float64).reshape(-1, emb.shape[1])
    for i in np.nonzero(got != want)[0]:
        d = ((flat[i] - emb[[got[i], want[i]]]) ** 2).sum(1)
        assert abs(d[0] - d[1]) <= TIE * max(d.max(), 1.0), (i, d)


@pytest.mark.parametrize("name", sorted(tt.TAMING_CONFIGS))
def test_encode_decode_match_jax(name):
    jc, params, tc, model = _pair(name)
    assert tc.num_resolutions == jt.TAMING_CONFIGS[name].num_resolutions
    x = _x()
    jz, jloss, jidx = jt.encode(params, jc, jnp.asarray(x))
    h = jt.conv2d(jt.encoder_forward(params["encoder"], jc, jnp.asarray(x)),
                  params["quant_conv"]["w"], params["quant_conv"]["b"])
    with torch.no_grad():
        th = tt._conv(model.quant_conv, tt.encoder_forward(model.encoder, torch.from_numpy(x)))
        tz, tloss, tidx = tt.encode(model, tc, torch.from_numpy(x), device="cpu")
    _close(th, h, LATENT_TOL)
    _codes_or_ties(params, h, tidx.numpy(), jidx)
    same = (tidx.numpy() == np.asarray(jidx))
    assert same.mean() > 0.9 and tidx.shape == jidx.shape
    _close(tz[torch.from_numpy(same)], np.asarray(jz)[same], LATENT_TOL)
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    with torch.no_grad():
        _close(tt.decode(model, tc, tz), jt.decode(params, jc, jz), IMAGE_TOL)
        codes = np.asarray(jidx).reshape(2, -1)
        hw = jidx.shape[1:]
        _close(tt.decode_code(model, tc, torch.from_numpy(codes.copy()), hw),
               jt.decode_code(params, jc, jnp.asarray(codes), hw), IMAGE_TOL)
        rec = tt.reconstruct(model, tc, torch.from_numpy(x), device="cpu")
    assert rec.shape == (2, PX, PX, 3) and bool(torch.isfinite(rec).all())


def test_attention_by_resolution():
    """Attention sits where the resolution is listed, in both halves, and
    each decoder level runs num_res_blocks + 1 blocks."""
    for name in tt.TAMING_CONFIGS:
        jc, _, tc, model = _pair(name)
        for dec in (False, True):
            assert tt._attn_gates(tc, dec) == jt._attn_gates(jc, dec)
        enc = [len(level.attn) > 0 for level in model.encoder.down]
        dec = [len(level.attn) > 0 for level in model.decoder.up]
        assert enc == tt._attn_gates(tc, False) and sum(enc) == 2
        assert dec == tt._attn_gates(tc, True) and sum(dec) == 2
        assert all(len(level.block) == tc.num_res_blocks + 1 for level in model.decoder.up)


@pytest.mark.parametrize("legacy", [True, False])
def test_quantizer_loss_order_and_raw_distances(legacy):
    jc, params, tc, model = _pair("vqgan_imagenet_f16_1024")
    jc, tc = dataclasses.replace(jc, legacy=legacy), dataclasses.replace(tc, legacy=legacy)
    z = np.random.default_rng(3).standard_normal((2, 3, 3, jc.embed_dim)).astype(np.float32)
    jzq, jloss, jidx = jt.quantize(params, jc, jnp.asarray(z))
    tzq, tloss, tidx = tt.quantize(model, tc, torch.from_numpy(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tzq.numpy(), np.asarray(jzq), atol=1e-6)
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    # raw L2: the nearest row of the un-normalised codebook
    d = ((z.reshape(-1, 1, jc.embed_dim) - params["embedding"][None]) ** 2).sum(-1)
    np.testing.assert_array_equal(tidx.numpy().ravel(), d.argmin(1))


USED = tuple(range(0, 64, 4))  # 16 of the 64 codebook rows


def _used(model, tc, x):
    """16 used rows: every other code the image takes, then rows it does
    not take, so that the remap meets known and unknown codes."""
    with torch.no_grad():
        raw = np.unique(tt.encode(model, tc, torch.from_numpy(x), device="cpu")[2].numpy())
    assert len(raw) >= 2
    rest = [i for i in range(tc.n_embed) if i not in raw]
    return tuple(sorted(int(i) for i in list(raw[::2]) + rest[:16 - len(raw[::2])]))


@pytest.mark.parametrize("unknown", ["extra", 3])
def test_remap_matches_jax(unknown):
    jc, params, tc, model = _pair("vqgan_openimage_f8_256")
    x = _x(4)
    used = _used(model, tc, x)
    jc = dataclasses.replace(jc, remap=used, unknown_index=unknown)
    tc = dataclasses.replace(tc, remap=used, unknown_index=unknown)
    _, _, jidx = jt.encode(params, jc, jnp.asarray(x))
    with torch.no_grad():
        _, _, tidx = tt.encode(model, tc, torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tc.re_embed == (17 if unknown == "extra" else 16)
    unknown_id = 16 if unknown == "extra" else 3
    assert int(tidx.max()) < tc.re_embed and (tidx == unknown_id).any()
    hw = tidx.shape[1:]
    codes = tidx.reshape(2, -1)
    np.testing.assert_allclose(tt.codebook_entry(model, tc, codes, hw).detach().numpy(),
                               np.asarray(jt.codebook_entry(params, jc, jnp.asarray(codes.numpy()),
                                                            hw)), atol=0)
    with torch.no_grad():
        _close(tt.decode_code(model, tc, codes, hw),
               jt.decode_code(params, jc, jnp.asarray(codes.numpy()), hw), IMAGE_TOL)


def test_remap_random_range_and_known_ids():
    jc, params, tc, model = _pair("vqgan_openimage_f8_256")
    x = _x(5)
    used = _used(model, tc, x)
    jc = dataclasses.replace(jc, remap=used, unknown_index="random")
    tc = dataclasses.replace(tc, remap=used, unknown_index="random")
    _, _, jidx = jt.encode(params, jc, jnp.asarray(x))
    with torch.no_grad():
        _, _, tidx = tt.encode(model, tc, torch.from_numpy(x),
                               generator=torch.Generator().manual_seed(0), device="cpu")
        raw = tt.encode(model, dataclasses.replace(tc, remap=None), torch.from_numpy(x),
                        device="cpu")[2]
    known = np.isin(raw.numpy(), used)
    assert 0 < known.mean() < 1  # both cases occur
    np.testing.assert_array_equal(tidx.numpy()[known], np.asarray(jidx)[known])
    np.testing.assert_array_equal(tidx.numpy()[known],
                                  np.searchsorted(used, raw.numpy()[known]))
    assert tidx.min() >= 0 and tidx.max() < len(used)


def test_loaders_read_the_lightning_layout(tmp_path):
    """The port's export in taming's state-dict keys is what the JAX
    package's converter reads (its tree equal to the one the port was
    built from); checkpoint.load_taming reads it back bit for bit, with a
    remap table from a .npy file."""
    jc, params, tc, model = _pair("vqgan_imagenet_f16_16384")
    sd = convert_ref.taming_reference_state_dict(model)
    assert "quantize.embedding.weight" in sd and "encoder.down.0.block.0.norm1.weight" in sd
    back = convert_taming_state_dict({k: v.numpy() for k, v in sd.items()}, jc)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    torch.save({"state_dict": sd}, tmp_path / "last.ckpt")
    name = "vqgan_imagenet_f16_16384"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tt.TAMING_CONFIGS, name, tc)
        loaded, lcfg = checkpoint.load_taming(str(tmp_path / "last.ckpt"), name, device="cpu")
        np.save(tmp_path / "used.npy", np.asarray(USED, np.int64))
        _, rcfg = checkpoint.load_taming(str(tmp_path / "last.ckpt"), name,
                                         remap=str(tmp_path / "used.npy"),
                                         unknown_index="extra", device="cpu")
    assert lcfg == tc and rcfg.remap == USED and rcfg.re_embed == 17
    for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(load_taming_checkpoint(str(tmp_path / "last.ckpt"), jc))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_taming_matches_the_jax_distribution():
    cfg = _narrow("vqgan_openimage_f8_16384")
    model = tt.init_taming(tt.TamingVQConfig(**dataclasses.asdict(cfg)), seed=0, device="cpu")
    w = model.encoder.conv_in.weight
    assert abs(float(w.std()) - 0.05) < 0.01 and not model.encoder.conv_in.bias.any()
    assert float(model.embedding.abs().max()) <= 1 / cfg.n_embed
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("fn", [latent_vae.sd_vae_reconstructor,
                                latent_vae.consistency_decoder_reconstructor])
def test_latent_vae_raises_without_diffusers(fn, monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusers", None)
    with pytest.raises(ImportError, match="diffusers"):
        fn("model_dir", device="cpu")
