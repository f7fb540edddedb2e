"""The port's segmentation evaluation against the JAX package's, on the CPU:
the mIoU functions, the mmseg DeepLabV3 and its loaders, mmseg's keep-ratio
front end, the Mask2Former key conversion and the segmenter dispatch. The
mmseg state dicts are `tests/test_mmseg_convert.py`'s synthetic ones (no
released checkpoint is in the repository).

Tolerances: the mIoU functions exact (integer confusion matrices, the same
float64 arithmetic); DeepLabV3 logits within 1e-5 of their largest and the
segmenters' labels equal (the same torch graph on both sides); the keep-ratio
resize 1e-5 absolute on normalised pixels; the Mask2Former conversion key
for key and bit for bit, and its inferred config equal.
"""
import sys

import numpy as np
import pytest
import torch

from controlar_tpu.convert import mmseg_seg as jmm
from controlar_tpu.eval import miou as jmiou
from controlar_tpu.eval import segmenter as jseg
from controlar_tpu_torch import convert_mmseg as tmm
from controlar_tpu_torch.eval import miou as tmiou
from controlar_tpu_torch.eval import segmenter as tseg
from tests.test_mmseg_convert import make_mmseg_deeplabv3_sd, make_mmseg_mask2former_sd
from tests.test_segmenter import tiny_segformer_dir  # noqa: F401 (a fixture)

LOGIT_TOL, RESIZE_ATOL = 1e-5, 1e-5


def _labels(n, h, w, k, seed, ignore=None):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, (n, h, w))
    if ignore is not None:
        lab[rng.random((n, h, w)) < 0.1] = ignore
    return lab


# ---------------------------------------------------------------------------
# mIoU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,ignore", [(5, 255), (7, 0)])
def test_confusion_matrix_matches_jax(k, ignore):
    gts = [_labels(2, 16, 12, k + 1, s, ignore) for s in (1, 2)]
    preds = [_labels(2, 16, 12, k, s + 10) for s in (1, 2)]
    j, t = jmiou.ConfusionMatrix(k, ignore), tmiou.ConfusionMatrix(k, ignore)
    for g, p in zip(gts, preds):
        j.update(g, p)
        t.update(g, p)
    np.testing.assert_array_equal(t.mat, j.mat)
    (jm, jiou), (tm, tiou) = j.miou(), t.miou()
    assert tm == jm
    np.testing.assert_array_equal(tiou, jiou)


def _stub_segmenter(k, seed):
    rng = np.random.default_rng(seed)

    def segment(images):
        # labels from the image's red channel, with some noise
        base = images[..., 0].astype(np.int64) * k // 256
        noise = rng.integers(0, k, base.shape)
        return np.where(rng.random(base.shape) < 0.3, noise, base)

    return segment


def _pairs(k, seed, ignore):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        img = rng.integers(0, 256, (2, 24, 20, 3)).astype(np.uint8)
        gt = img[..., 0].astype(np.int64) * k // 256
        gt[rng.random(gt.shape) < 0.1] = ignore
        out.append((img, gt))
    return out


def test_miou_eval_matches_jax():
    pairs = _pairs(6, 3, 255)
    want = jmiou.miou_eval(_stub_segmenter(6, 4), pairs, 6)
    assert tmiou.miou_eval(_stub_segmenter(6, 4), pairs, 6) == want and 0 < want < 1


def test_reference_protocols_match_jax():
    """reference_confusion_update / reference_miou and both protocols, with
    their quirks: ADE20K's 1-based labels with 0 ignored and predictions
    shifted +1, COCO-Stuff's 255 ignored; a hallucinated class dilutes."""
    for k, ignore, offset in ((150, 0, 1), (171, 255, 0)):
        jc = np.zeros((k + 1, k + 1), np.int64)
        tc = np.zeros_like(jc)
        for s in range(3):
            pred = _labels(1, 16, 16, k, s)[0]
            gt = _labels(1, 16, 16, k + offset, s + 5, ignore)[0]
            jmiou.reference_confusion_update(jc, pred, gt, k, ignore, offset)
            tmiou.reference_confusion_update(tc, pred, gt, k, ignore, offset)
        np.testing.assert_array_equal(tc, jc)
        assert tmiou.reference_miou(tc, k) == jmiou.reference_miou(jc, k)
    pairs150 = [(img, np.clip(gt, 0, 150)) for img, gt in _pairs(150, 6, 0)]
    assert tmiou.ade20k_miou(_stub_segmenter(150, 7), pairs150) == \
        jmiou.ade20k_miou(_stub_segmenter(150, 7), pairs150)
    pairs171 = _pairs(171, 8, 255)
    assert tmiou.cocostuff_miou(_stub_segmenter(171, 9), pairs171) == \
        jmiou.cocostuff_miou(_stub_segmenter(171, 9), pairs171)


# ---------------------------------------------------------------------------
# DeepLabV3 and the mmseg loaders
# ---------------------------------------------------------------------------

def test_deeplabv3_loads_mmseg_by_identity_and_matches_jax():
    sd = make_mmseg_deeplabv3_sd()
    jmodel, jn = jmm.load_mmseg_deeplabv3(sd)
    tmodel, tn = tmm.load_mmseg_deeplabv3(sd)
    assert tn == jn == 7 and not any(p.requires_grad for p in tmodel.parameters())
    for (k, a), (k2, b) in zip(jmodel.state_dict().items(), tmodel.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, got = jmodel(x), tmodel(x)
    assert got.shape == (2, 7, 64, 96)
    assert float((got - want).abs().max()) <= LOGIT_TOL * float(want.abs().max())


def test_deeplabv3_rejects_layout_drift():
    sd = make_mmseg_deeplabv3_sd()
    sd["backbone.bogus.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unmatched"):
        tmm.load_mmseg_deeplabv3(sd)
    sd = make_mmseg_deeplabv3_sd()
    del sd["decode_head.bottleneck.bn.running_var"]
    with pytest.raises(ValueError, match="missing"):
        tmm.load_mmseg_deeplabv3(sd)


@pytest.mark.parametrize("hw,scale", [((64, 64), (2048, 512)), ((384, 384), (2048, 512)),
                                      ((48, 80), (2560, 640)), ((700, 500), (2048, 512))])
def test_keep_ratio_resize_matches_jax(hw, scale):
    images = np.random.default_rng(1).integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    want = jmm._keep_ratio_resize(images, scale)
    got = tmm._keep_ratio_resize(images, scale, device="cpu")
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= RESIZE_ATOL


def test_segmenters_match_jax(tmp_path):
    """load_mmseg_segmenter and make_segmenter on an mmseg .pth (the
    {"state_dict", "meta"} container): the JAX package's labels."""
    path = tmp_path / "deeplabv3.pth"
    torch.save({"state_dict": make_mmseg_deeplabv3_sd(), "meta": {"mmseg_version": "1.0.0"}},
               path)
    images = np.random.default_rng(2).integers(0, 256, (3, 64, 48, 3)).astype(np.uint8)
    want = jmm.load_mmseg_segmenter(str(path))(images)
    got = tmm.load_mmseg_segmenter(str(path), device="cpu")(images)
    assert got.shape == (3, 64, 48) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tseg.make_segmenter(str(path), device="cpu")(images), want)
    np.testing.assert_array_equal(
        tmm.load_mmseg_segmenter(str(path), device="cpu", label_offset=1)(images), want + 1)


# ---------------------------------------------------------------------------
# Mask2Former key conversion
# ---------------------------------------------------------------------------

def test_mask2former_conversion_matches_jax():
    sd = make_mmseg_mask2former_sd()
    want, junmatched = jmm.convert_mask2former_state(sd)
    got, tunmatched = tmm.convert_mask2former_state(sd)
    assert tunmatched == junmatched == []
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert tmm.detect_mmseg_kind(sd) == "mask2former"
    assert tmm._merge_perm(3) == jmm._merge_perm(3)
    sd["decode_head.pixel_decoder.bogus.weight"] = torch.zeros(2)
    assert tmm.convert_mask2former_state(sd)[1] == ["decode_head.pixel_decoder.bogus.weight"]


def test_mask2former_config_matches_jax():
    pytest.importorskip("transformers")
    sd = make_mmseg_mask2former_sd()
    want = jmm.mask2former_config_from_mmseg(jmm.strip_mmseg_checkpoint(sd))
    got = tmm.mask2former_config_from_mmseg(tmm.strip_mmseg_checkpoint(sd))
    assert got.to_dict() == want.to_dict()
    assert got.num_attention_heads == 2 and got.num_labels == 7


def test_unrecognised_checkpoint_raises():
    with pytest.raises(ValueError, match="unrecognized"):
        tmm.detect_mmseg_kind({"backbone.x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# transformers segmenters
# ---------------------------------------------------------------------------

def test_hf_segmenter_matches_jax(tiny_segformer_dir):
    """A tiny random SegFormer directory (tests/test_segmenter.py's)."""
    images = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), np.uint8)
    want = jseg.make_segmenter(tiny_segformer_dir)(images)
    got = tseg.make_segmenter(tiny_segformer_dir, device="cpu")(images)
    assert got.shape == (3, 32, 32) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_hf_segmenter_raises_without_transformers(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tseg.make_segmenter(str(tmp_path), device="cpu")
