"""The port's c2i evaluation against the JAX package's, on the CPU: the FID
InceptionV3 and its loaders, the FID statistics and distance, the Inception
Score, the precision / recall manifolds, `evaluate_all`, the c2i sampler,
and the CLIP-score / clean-FID wrappers. The same seed-made numpy inputs on
both sides, the weights carried over by `convert.inception_from_jax`.

Tolerances:
- InceptionV3 at full width (the JAX init with its batch norms and fc
  bias drawn at random), 2 images of 64 x 80 resized to 299: pool3,
  spatial and logits within 1e-4 of each output's largest in fp32, and
  within 2e-2 of it in bf16 (every one of ~95 layers rounds to bf16 in
  either package, in another order; the two bf16 runs differ by ~7e-3).
- resize_bilinear_tf1: 1e-5 absolute on [0, 1] images, up- and down-scales.
- The pytorch-fid loader: bit for bit (the JAX package's export layout).
- FIDStats: mean and covariance 1e-12 relative; the Frechet distance 1e-6
  relative (both take scipy's sqrtm of the same float64 product, and the
  eps retry on a matrix without a finite root).
- Inception Score: 1e-6 relative (the softmax in fp32 in either package).
- Manifold radii: 1e-5 relative (fp32 squared distances in another
  matmul order); precision and recall exact, on features checked to hold
  no float64 distance within 1e-4 of a radius.
- evaluate_all on two small npz files, fp32 features in both (either
  package's Evaluator's bf16 default set to fp32 for the test): IS, FID and sFID
  within 1e-3 relative (the features agree to ~2e-6 of their largest, the
  statistics of 6-8 images amplify it), precision and recall exact; with
  the reference's mu / sigma precomputed, the same numbers without
  precision and recall.
- sample_c2i_fid on a tiny fp32 pipeline with top_k=1: tokens exact, images
  within one uint8 step (the VQ decoder in fp32), the same files and
  samples.npz layout, the tail batch padded and cut.
- clip_score: the JAX package's value within 1e-6 (the same transformers
  model on both sides); without transformers or cleanfid, the wrappers
  raise ImportError.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu import generate as jgen_mod
from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.config import VQConfig as JVQConfig
from controlar_tpu.convert.torch_inception import (convert_inception_state_dict,
                                                   export_inception_state_dict)
from controlar_tpu.eval import evaluator as jev
from controlar_tpu.eval import inception as jinc
from controlar_tpu.eval import metrics as jmetrics
from controlar_tpu.eval import sampler as jsampler
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.pipeline import ControlARPipeline as JPipeline
from controlar_tpu_torch import checkpoint, convert, convert_ref
from controlar_tpu_torch import generate as tgen_mod
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.eval import evaluator as tev
from controlar_tpu_torch.eval import inception as tinc
from controlar_tpu_torch.eval import metrics as tmetrics
from controlar_tpu_torch.eval import sampler as tsampler
from controlar_tpu_torch.eval import t2i_eval as tt2i
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.pipeline import ControlARPipeline as TPipeline
from tests.test_t2i_eval import tiny_clip_dir  # noqa: F401 (a fixture)
from tests.test_torch_consistency import _images, _jit_init, _np_tree, _vq_pair

FP32_TOL, BF16_TOL = 1e-4, 2e-2
RESIZE_ATOL = 1e-5
FID_RTOL, IS_RTOL, RADII_RTOL, EVAL_RTOL = 1e-6, 1e-6, 1e-5, 1e-3


@functools.lru_cache(maxsize=None)
def _inception_pair(draw_bn: bool = True):
    """(JAX tree, port InceptionV3): the JAX init, with its batch norms and
    fc bias drawn from a seed when draw_bn, carried over by
    convert.inception_from_jax."""
    params = _np_tree(jinc.init_inception_params(jax.random.PRNGKey(0)))
    if not draw_bn:
        return params, convert.inception_from_jax(params)
    rng = np.random.default_rng(0)

    def draw(node):
        if "bn_scale" in node:
            c = node["bn_scale"].shape
            node["bn_scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            node["bn_bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            node["bn_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            node["bn_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        else:
            for v in node.values():
                draw(v)

    draw({k: v for k, v in params.items() if k != "fc"})
    params["fc"]["b"] = rng.standard_normal(params["fc"]["b"].shape).astype(np.float32)
    return params, convert.inception_from_jax(params)


def _features_jax(params, images, dtype):
    fn = jax.jit(lambda p, x: jinc.inception_features(p, x, compute_dtype=dtype))
    return [np.asarray(a) for a in fn(jax.tree.map(jnp.asarray, params), jnp.asarray(images))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inception_matches_jax(dtype):
    params, model = _inception_pair()
    images = np.random.default_rng(1).integers(0, 256, (2, 64, 80, 3), np.uint8)
    want = _features_jax(params, images, getattr(jnp, dtype))
    got = tinc.inception_features(model, images, getattr(torch, dtype))
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    dims = (tinc.POOL_DIM, tinc.SPATIAL_DIM, tinc.NUM_LOGITS)
    for name, w, g, dim in zip(("pool3", "spatial", "logits"), want, got, dims):
        assert g.shape == w.shape == (2, dim) and g.dtype == torch.float32, name
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g.numpy() - w).max() <= tol * scale, name


def test_logits_have_no_bias_and_spatial_is_nhwc():
    """The logits are pool3 @ fc.weight.T with the (non-zero) bias left
    out; the spatial features are Mixed_6d's branch1x1, channels [:7],
    flattened in NHWC order."""
    _, model = _inception_pair()
    images = np.random.default_rng(2).integers(0, 256, (1, 48, 48, 3), np.uint8)
    pool3, spatial, logits = tinc.inception_features(model, images)
    assert float(model.fc.bias.abs().max()) > 0
    torch.testing.assert_close(logits, pool3 @ model.fc.weight.T, rtol=1e-6, atol=1e-9)
    b1 = {}
    orig = tinc._block_c

    def spy(p, x):
        out = orig(p, x)
        if p is model.Mixed_6d:
            b1["x"] = out[1]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinc, "_block_c", spy)
        tinc.inception_features(model, images)
    assert b1["x"].shape[1:] == (192, 17, 17)
    torch.testing.assert_close(spatial, b1["x"][:, :7].permute(0, 2, 3, 1).reshape(1, -1))


@pytest.mark.parametrize("shape,out", [((64, 80), (299, 299)), ((384, 512), (299, 299)),
                                       ((7, 5), (3, 11)), ((299, 299), (299, 299))])
def test_resize_bilinear_tf1_matches_jax(shape, out):
    x = np.random.default_rng(3).uniform(0, 1, (2, *shape, 3)).astype(np.float32)
    want = np.asarray(jinc.resize_bilinear_tf1(jnp.asarray(x), *out))
    got = tinc.resize_bilinear_tf1(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape == (2, *out, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_resize_is_not_half_pixel():
    """Output pixel i samples input i * in / out: 2 -> 4 on one axis reads
    0, 0.5, 1, 1.5 (the last clamped), unlike align_corners=False."""
    r = torch.tensor([0.0, 2.0]).reshape(1, 1, 2, 1)
    np.testing.assert_allclose(tinc.resize_bilinear_tf1(r, 1, 4).ravel().numpy(),
                               [0.0, 1.0, 2.0, 2.0])


def test_inception_loaders_read_pytorch_fid_layout(tmp_path):
    """The JAX package's export of its tree (pytorch-fid's keys) through
    convert_ref.inception_from_state_dict and checkpoint.load_inception:
    the port's module of convert.inception_from_jax, bit for bit; the
    port's own export converts back to the JAX tree; a missing fc.bias is
    zero and num_batches_tracked is ignored."""
    params, model = _inception_pair()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_inception_state_dict(params).items()}
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    loaded = convert_ref.inception_from_state_dict(sd, device="cpu")
    for (k, a), b in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), k
    back = convert_inception_state_dict(convert_ref.inception_state_dict(loaded))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    del sd["fc.bias"]
    torch.save({"state_dict": sd}, tmp_path / "pt_inception.pth")
    from_file = checkpoint.load_inception(str(tmp_path / "pt_inception.pth"), device="cpu")
    assert torch.equal(from_file.fc.weight, model.fc.weight)
    assert not from_file.fc.bias.any() and not from_file.fc.weight.requires_grad


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_fid_stats_and_distance_match_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((200, 64)) @ rng.standard_normal((64, 64)) * 0.3
    b = rng.standard_normal((150, 64)) + 0.2
    stats = {}
    for name, cls in (("jax", jmetrics.FIDStats), ("port", tmetrics.FIDStats)):
        out = []
        for feats in (a, b):
            s = cls(64)
            for chunk in np.array_split(feats.astype(np.float32), 3):
                s.update(chunk)
            out.append(s.finalize())
        stats[name] = out
    for (jm, js), (tm, ts) in zip(stats["jax"], stats["port"]):
        np.testing.assert_allclose(tm, jm, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ts, js, rtol=1e-12, atol=1e-15)
    (m1, s1), (m2, s2) = stats["port"]
    want = jmetrics.frechet_distance(m1, s1, m2, s2)
    assert tmetrics.frechet_distance(m1, s1, m2, s2) == pytest.approx(want, rel=FID_RTOL)
    assert tmetrics.frechet_distance(m1, s1, m1, s1) == pytest.approx(0.0, abs=1e-8)
    # no finite root: the eps retry, as the JAX function takes it
    nil, eye = np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2)
    with np.errstate(all="ignore"), pytest.warns(Warning):
        got = tmetrics.frechet_distance(np.zeros(2), nil, np.ones(2), eye)
    with np.errstate(all="ignore"), pytest.warns(Warning):
        want = jmetrics.frechet_distance(np.zeros(2), nil, np.ones(2), eye)
    assert np.isfinite(got) and got == pytest.approx(want, rel=FID_RTOL)


@pytest.mark.parametrize("split", [5000, 7])
def test_inception_score_matches_jax(split):
    logits = np.random.default_rng(5).standard_normal((30, 1008)).astype(np.float32) * 3
    want = jev.Evaluator.inception_score(logits, split)
    assert tev.Evaluator.inception_score(logits, split) == pytest.approx(want, rel=IS_RTOL)


def _manifold_inputs():
    rng = np.random.default_rng(6)
    ref = rng.standard_normal((60, 32)).astype(np.float32)
    smp = (rng.standard_normal((50, 32)) * 1.1 + 0.1).astype(np.float32)
    return ref, smp


def _d64(u, v):
    u, v = u.astype(np.float64), v.astype(np.float64)
    return np.maximum((u * u).sum(1)[:, None] - 2 * u @ v.T + (v * v).sum(1)[None], 0)


def test_manifold_radii_and_prec_recall_match_jax():
    ref, smp = _manifold_inputs()
    blocks = dict(row_batch=16, col_batch=24)
    for f, e in ((ref, smp), (smp, ref)):
        want = jev.manifold_radii(f, 3, **blocks)
        got = tev.manifold_radii(f, 3, **blocks, device="cpu")
        np.testing.assert_allclose(got, want, rtol=RADII_RTOL)
        # the inputs hold no near-tie: each float64 distance of the other
        # set is 1e-4 away from every radius
        r64 = np.partition(_d64(f, f), 3, axis=1)[:, 3]
        assert (np.abs(_d64(e, f) - r64[None]) / r64[None]).min() > 1e-4
    evaluator = tev.Evaluator(tinc.init_inception(device="cpu"), device="cpu")
    want = jev.Evaluator.compute_prec_recall(None, ref, smp, **blocks)
    got = evaluator.compute_prec_recall(ref, smp, **blocks)
    assert got == want and 0 < got[0] < 1 and 0 < got[1] < 1
    inside = tev.manifold_inside(ref, tev.manifold_radii(ref, device="cpu"), smp, device="cpu")
    assert inside.dtype == bool and inside.mean() == got[0]


def test_evaluate_all_matches_jax(tmp_path, monkeypatch):
    """Both packages' evaluate_all on the same two npz files, fp32
    features, the JAX init's Inception (its batch norms the identity: drawn
    biases collapse the features to within ~1e-3 of their norm, where fp32
    distances |u|^2 - 2 u.v + |v|^2 cancel to noise); then with the
    reference's statistics precomputed."""
    params, model = _inception_pair(draw_bn=False)
    rng = np.random.default_rng(7)
    ref = _images(8, 64, 64, seed=8)
    smp = np.clip(_images(6, 64, 64, seed=9).astype(np.int32)
                  + rng.integers(-20, 21, (6, 64, 64, 3)), 0, 255).astype(np.uint8)
    np.savez(tmp_path / "ref.npz", arr_0=ref)
    np.savez(tmp_path / "samples.npz", arr_0=smp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev.Evaluator.__init__, "__defaults__", (64, jnp.float32))
        want = jev.evaluate_all(jax.tree.map(jnp.asarray, params), str(tmp_path / "ref.npz"),
                                str(tmp_path / "samples.npz"), batch_size=4)
    # the Frechet distance is a pure function of its four arrays: the
    # precomputed-statistics call below reuses a result computed on equal
    # arrays (two 2048 x 2048 sqrtm less)
    memo = {}

    def frechet(mu1, sigma1, mu2, sigma2, eps=1e-6):
        arrays = (mu1, sigma1, mu2, sigma2)
        key = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays) + repr(eps).encode()
        if key not in memo:
            memo[key] = tmetrics.frechet_distance(*arrays, eps)
        return memo[key]

    monkeypatch.setattr(tev, "frechet_distance", frechet)
    monkeypatch.setattr(tev.Evaluator.__init__, "__defaults__", (64, torch.float32, "cuda"))
    got = tev.evaluate_all(model, str(tmp_path / "ref.npz"), str(tmp_path / "samples.npz"),
                           batch_size=4, device="cpu")
    assert set(got) == set(want) == {"inception_score", "fid", "sfid", "precision", "recall"}
    for k in ("inception_score", "fid", "sfid"):
        assert np.isfinite(got[k]) and got[k] == pytest.approx(want[k], rel=EVAL_RTOL), k
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    # no near-tie: each float64 distance 1e-3 away from every radius
    evaluator = tev.Evaluator(model, batch_size=4, compute_dtype=torch.float32, device="cpu")
    pool, spatial, _ = evaluator.compute_activations(ref)
    pool_s = evaluator.compute_activations(smp)[0]
    for f, e in ((pool, pool_s), (pool_s, pool)):
        r64 = np.partition(_d64(f, f), 3, axis=1)[:, 3]
        assert (np.abs(_d64(e, f) - r64[None]) / r64[None]).min() > 1e-3

    st, sp = tev.compute_statistics(pool), tev.compute_statistics(spatial)
    np.savez(tmp_path / "ref_stats.npz", arr_0=ref[:1], mu=st.mu, sigma=st.sigma,
             mu_s=sp.mu, sigma_s=sp.sigma)
    pre = tev.evaluate_all(model, str(tmp_path / "ref_stats.npz"),
                           str(tmp_path / "samples.npz"), batch_size=4, device="cpu")
    assert set(pre) == {"inception_score", "fid", "sfid"} and len(memo) == 2
    for k in pre:
        assert pre[k] == pytest.approx(want[k], rel=EVAL_RTOL), k


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

_VQ = dict(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16, num_res_blocks=1)
_ADAPTER = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4,
                layerscale=True)


@functools.lru_cache(maxsize=None)
def _c2i_pipelines():
    """(JAX pipeline, port pipeline on the CPU): a tiny c2i model (64 px,
    16 tokens, 3 layers) with Canny control, the same weights."""
    kw = dict(model_type="c2i", dim=64, n_layer=3, n_head=4, vocab_size=96, num_classes=10,
              cls_token_num=1, block_size=16)
    cfg = JGPTConfig(**kw)
    params = _jit_init(jgpt.init_gpt_params)(jax.random.PRNGKey(0), cfg)
    ad_cfg = jvit.ViTConfig(**_ADAPTER)
    ad = _jit_init(jvit.init_vit_params)(jax.random.PRNGKey(3), ad_cfg)
    vq, port_vq = _vq_pair()
    jpipe = JPipeline(gpt_cfg=cfg, gpt_params=params, vq_cfg=JVQConfig(**_VQ), vq_params=vq,
                      adapter_cfg=ad_cfg, adapter_params=ad)
    tpipe = TPipeline(gpt_cfg=GPTConfig(**kw),
                      gpt=convert.gpt_from_jax(_np_tree(params), GPTConfig(**kw)),
                      vq_cfg=VQConfig(**_VQ), vq=port_vq, adapter_cfg=tvit.ViTConfig(**_ADAPTER),
                      adapter=convert.vit_from_jax(_np_tree(ad), tvit.ViTConfig(**_ADAPTER)),
                      device="cpu")
    return jpipe, tpipe


def _recording(module, calls):
    orig = module.generate

    def generate(*args, **kw):
        out = orig(*args, **kw)
        calls.append(np.asarray(out))
        return out

    return generate


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_sample_c2i_fid_matches_jax(tmp_path, rank, world):
    """5 images in batches of 2 (the tail batch padded to 2, then cut),
    Canny on 4 condition images, greedy (top_k=1); as rank `rank` of
    `world` processes (jax.process_index / count on the JAX side,
    torch.distributed's on the port's): the same tokens per call, images
    within one uint8 step, the same PNG names, samples.npz with arr_0 only
    when there is one process."""
    jpipe, tpipe = _c2i_pipelines()
    cond = _images(4, 64, 64, seed=10)
    calls = {"jax": [], "port": []}
    kw = dict(batch_size=2, num_classes=10, cfg_scale=4.0, top_k=1, seed=3,
              condition_images=cond)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen_mod, "generate", _recording(jgen_mod, calls["jax"]))
        mp.setattr(tgen_mod, "generate", _recording(tgen_mod, calls["port"]))
        mp.setattr(jax, "process_index", lambda: rank)
        mp.setattr(jax, "process_count", lambda: world)
        mp.setattr(tsampler, "_shard", lambda: (rank, world))
        want = jsampler.sample_c2i_fid(jpipe, 5, out_dir=str(tmp_path / "jax"), **kw)
        got = tsampler.sample_c2i_fid(tpipe, 5, out_dir=str(tmp_path / "port"), device="cpu",
                                      **kw)
    n = len(range(rank, 5, world))
    assert got.shape == want.shape == (n, 64, 64, 3) and got.dtype == np.uint8
    assert len(calls["port"]) == len(calls["jax"]) == -(-n // 2)
    for j, t in zip(calls["jax"], calls["port"]):
        np.testing.assert_array_equal(t, j)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    names = {d: sorted(p.name for p in (tmp_path / d / "images").iterdir())
             for d in ("jax", "port")}
    assert names["port"] == names["jax"] == sorted(f"{i}.png" for i in range(rank, 5, world))
    assert (tmp_path / "port" / "samples.npz").exists() == (world == 1)
    if world == 1:
        with np.load(tmp_path / "port" / "samples.npz") as f, \
                np.load(tmp_path / "jax" / "samples.npz") as g:
            assert f.files == g.files == ["arr_0"]
            np.testing.assert_array_equal(f["arr_0"], got)
            assert f["arr_0"].shape == g["arr_0"].shape


def test_sample_c2i_fid_refuses_another_device():
    _, tpipe = _c2i_pipelines()
    with pytest.raises(ValueError, match="pipeline"):
        tsampler.sample_c2i_fid(tpipe, 1, device="meta")


# ---------------------------------------------------------------------------
# t2i wrappers
# ---------------------------------------------------------------------------

def test_clip_score_matches_jax(tiny_clip_dir):
    """A tiny random CLIP saved to a directory (tests/test_t2i_eval.py's)."""
    from controlar_tpu.eval import t2i_eval as jt2i

    d = tiny_clip_dir
    imgs = np.random.default_rng(11).integers(0, 256, (3, 32, 32, 3), np.uint8)
    texts = ["a cat", "a dog", "red"]
    for how_many in (None, 2):
        want = jt2i.clip_score(imgs, texts, d, how_many=how_many)
        got = tt2i.clip_score(imgs, texts, d, device="cpu", how_many=how_many)
        assert -1 <= got <= 1 and got == pytest.approx(want, abs=1e-6)


def test_t2i_wrappers_raise_without_their_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "cleanfid", None)
    with pytest.raises(ImportError, match="cleanfid"):
        tt2i.clean_fid("a", "b")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tt2i.clip_score(np.zeros((1, 8, 8, 3), np.uint8), ["a"], "dir", device="cpu")
