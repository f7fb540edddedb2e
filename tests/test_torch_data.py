"""The port's data slice against the JAX package's, on the CPU: the t2i
control, c2i and jsonl datasets item by item with the same seeds, on trees
the JAX package's writers made (read directly, not through the threaded
loader, whose draw order is not fixed); .car files byte for byte and read
across packages; the label transforms, crops, image folders and ImageNet
names.

Tolerances: items, files and integer maps equal; float label transforms
within 1e-6 (the same fp32 ops), the antialiased bilinear resize within
2e-3 (torch's antialias kernel against jax.image.resize's, the limit
tests/test_label_transforms.py holds the JAX one to against torch).
"""
import json
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controlar_tpu.config import VQConfig
from controlar_tpu.data import augmentation as jaug
from controlar_tpu.data import carpack as jcar
from controlar_tpu.data import extract as jext
from controlar_tpu.data import image_folder as jif
from controlar_tpu.data import imagenet_labels as jlab
from controlar_tpu.data import label_transforms as jlt
from controlar_tpu.data import t2i_control as jtc
from controlar_tpu.data import t2i_jsonl as jjs
from controlar_tpu_torch.data import augmentation as taug
from controlar_tpu_torch.data import carpack as tcar
from controlar_tpu_torch.data import image_folder as tif
from controlar_tpu_torch.data import imagenet_labels as tlab
from controlar_tpu_torch.data import label_transforms as tlt
from controlar_tpu_torch.data import t2i_control as ttc
from controlar_tpu_torch.data import t2i_jsonl as tjs
from tests.port_data_helpers import random_vq_params

VQ_KW = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16,
             encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2))
PX = 32
N = 6
FEAT_LENS = (3, 12, 7, 1, 9, 5)


class _FeatureT5:
    """An embedder whose i-th caption has FEAT_LENS[i % N] valid tokens."""

    def __init__(self):
        self.calls = 0

    def get_text_embeddings(self, texts):
        rng = np.random.default_rng(self.calls)
        self.calls += 1
        emb = rng.standard_normal((len(texts), 12, 2048)).astype(np.float32)
        lens = [FEAT_LENS[int(t.split()[-1]) % N] if t else 1 for t in texts]
        mask = (np.arange(12)[None, :] < np.asarray(lens)[:, None]).astype(np.int64)
        return emb, mask


def _samples(n=N, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = {"image": rng.integers(0, 255, (PX + 8, PX + 4, 3)).astype(np.uint8),
             "caption": f"a photo number {i}" if i != 4 else None,
             "control": rng.integers(0, 255, (PX, PX, 3)).astype(np.uint8),
             "label": rng.integers(0, 20, (PX, PX)).astype(np.uint8)}
        out.append(s)
    return out


@pytest.fixture(scope="module")
def t2i_tree(tmp_path_factory):
    """A t2i tree written by the JAX package's extract_tree (item 4 has no
    caption, so both datasets fall back to their dummy item there), with
    control_depth copied from control."""
    root = tmp_path_factory.mktemp("t2i") / "tree"
    cfg = VQConfig(**VQ_KW)
    params = jax.tree.map(jnp.asarray, random_vq_params(cfg))
    jext.extract_tree(str(root), _samples(), params, cfg, t5_embedder=_FeatureT5(),
                      image_size=PX, batch_images=4)
    shutil.copytree(root / "control", root / "control_depth")
    return str(root)


def _equal_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("ct,extras", [("canny", {}), ("seg", dict(get_image=True,
                                                                    get_label=True)),
                                       ("depth", dict(get_prompt=True))])
def test_t2i_control_dataset_matches_jax(t2i_tree, ct, extras):
    kw = dict(code_path=t2i_tree, condition_type=ct, image_size=PX, **extras)
    jds = jtc.T2IControlCodeDataset(jtc.T2IControlConfig(**kw))
    tds = ttc.T2IControlCodeDataset(ttc.T2IControlConfig(**kw))
    assert len(tds) == len(jds) == N
    for i in range(N):
        _equal_items(tds[i], jds[i])
    valid = [float(tds[i]["valid"]) for i in range(N)]
    assert valid == [1.0, 1.0, 1.0, 1.0, 0.0, 1.0]  # item 4: no caption file
    assert int(tds[1]["emb_mask"].sum()) == FEAT_LENS[1]
    batch = tds.make_batch([tds[i] for i in range(3)])
    jbatch = jds.make_batch([jds[i] for i in range(3)])
    _equal_items(batch, jbatch)


@pytest.fixture(scope="module")
def c2i_tree(tmp_path_factory):
    """A c2i tree (flip mode, Canny) written by the JAX package's
    extract_c2i_tree, 5 samples; codes (1, 2, T)."""
    root = tmp_path_factory.mktemp("c2i")
    cfg = VQConfig(**VQ_KW)
    params = jax.tree.map(jnp.asarray, random_vq_params(cfg))
    rng = np.random.default_rng(3)
    samples = [{"image": rng.integers(0, 255, (PX + 6, PX + 2, 3)).astype(np.uint8),
                "label": 7 * i} for i in range(5)]
    jext.extract_c2i_tree(str(root), samples, params, cfg, image_size=PX,
                          conditions=("canny",), batch_images=2)
    return str(root / f"imagenet{PX}")


@pytest.mark.parametrize("flip_aug,with_cond", [(True, True), (False, True), (True, False)])
def test_c2i_dataset_matches_jax(c2i_tree, flip_aug, with_cond):
    args = (f"{c2i_tree}_codes", f"{c2i_tree}_labels",
            f"{c2i_tree}_canny_imagesnpy" if with_cond else None)
    jds = jtc.C2ICodeDataset(*args, flip_aug=flip_aug, seed=5)
    tds = ttc.C2ICodeDataset(*args, flip_aug=flip_aug, seed=5)
    assert len(tds) == len(jds) == 5
    for i in list(range(5)) * 4:  # the same draws, in the same order
        _equal_items(tds[i], jds[i])


def test_c2i_dataset_aug_dir_mixing_matches_jax(tmp_path):
    """A 'ten_crop_105' sibling tree mixed in with p=0.5, draw for draw."""
    for root, marker in [(tmp_path / "ten_crop", 0), (tmp_path / "ten_crop_105", 1000)]:
        for sub in ["codes", "labels", "cond"]:
            os.makedirs(root / sub, exist_ok=True)
        for i in range(6):
            np.save(root / "codes" / f"{i}.npy", np.full((1, 3, 16), marker + i, np.int64))
            np.save(root / "labels" / f"{i}.npy", np.array([marker + i]))
            np.save(root / "cond" / f"{i}.npy", np.full((3, 1, 4, 4), marker % 255 + i,
                                                        np.uint8))
    base = tmp_path / "ten_crop"
    args = (str(base / "codes"), str(base / "labels"), str(base / "cond"))
    jds, tds = jtc.C2ICodeDataset(*args, seed=3), ttc.C2ICodeDataset(*args, seed=3)
    assert tds.aug_code_dir == jds.aug_code_dir == str(tmp_path / "ten_crop_105" / "codes")
    labels = []
    for i in list(range(6)) * 10:
        item = tds[i]
        _equal_items(item, jds[i])
        labels.append(int(item["labels"]))
    assert 0 < np.mean([lab >= 1000 for lab in labels]) < 1


def _jsonl_tree(tmp_path, n=5):
    os.makedirs(tmp_path / "lists", exist_ok=True)
    rng = np.random.default_rng(0)
    recs = []
    for root in ("t5", "t5_short"):
        os.makedirs(tmp_path / root / "part0", exist_ok=True)
    for i in range(n):
        p = tmp_path / f"img_{i}.png"
        size = 24 if i == 2 else 40  # item 2 is under image_size: dummy
        Image.fromarray(rng.integers(0, 255, (size, size + 6, 3)).astype(np.uint8)).save(p)
        recs.append({"image_path": str(p)})
        for root, length in (("t5", 9 + i), ("t5_short", 3 + i)):
            if i != 3 or root == "t5_short":  # item 3 lacks its long feature
                np.save(tmp_path / root / "part0" / f"{i}.npy",
                        rng.standard_normal((1, length, 2048)).astype(np.float32))
    recs.append({"image_path": str(tmp_path / "missing.png")})
    with open(tmp_path / "lists" / "part0.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    return n + 1


def test_jsonl_dataset_matches_jax(tmp_path):
    n = _jsonl_tree(tmp_path)
    kw = dict(data_path=str(tmp_path / "lists"), t5_feat_path=str(tmp_path / "t5"),
              short_t5_feat_path=str(tmp_path / "t5_short"), image_size=32)

    def crop(aug, seed):
        rng = random.Random(seed)
        return lambda img: aug.random_crop_arr(img, 32, rng=rng)

    jds = jjs.Text2ImgJsonlDataset(jjs.T2IJsonlConfig(**kw), transform=crop(jaug, 1), seed=2)
    tds = tjs.Text2ImgJsonlDataset(tjs.T2IJsonlConfig(**kw), transform=crop(taug, 1), seed=2)
    assert len(tds) == len(jds) == n
    valid = []
    for i in list(range(n)) * 3:
        item = tds[i]
        _equal_items(item, jds[i])
        valid.append(float(item["valid"]))
    assert 0 < sum(valid) < len(valid)
    _equal_items(tds.make_batch([tds[0], tds[1]]), jds.make_batch([jds[0], jds[1]]))


# --- carpack -----------------------------------------------------------------


def _records(n=4):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, 1000, (64,)).astype(np.int32),
             "image": rng.integers(0, 255, (16, 16, 3)).astype(np.uint8),
             "caption_emb": rng.standard_normal((7, 32)).astype(np.float32),
             "half": rng.standard_normal((3,)).astype(np.float16),
             "mask": rng.random(5) > 0.5, "labels": np.int64(i),
             "blob": bytes([i] * 10)} for i in range(n)]


def _write(mod, path, records):
    with mod.CarpackWriter(str(path)) as w:
        for r in records:
            w.write(r)


def _equal_records(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, bytes):
            assert got[k] == v
        else:
            assert got[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[k], v)


def test_carpack_files_are_byte_identical_and_cross_readable(tmp_path):
    recs = _records()
    _write(jcar, tmp_path / "jax.car", recs)
    _write(tcar, tmp_path / "port.car", recs)
    assert (tmp_path / "jax.car").read_bytes() == (tmp_path / "port.car").read_bytes()
    for path in (tmp_path / "jax.car", tmp_path / "port.car"):
        readers = [tcar.CarpackReader(str(path)), tcar.CarpackReader(str(path), True),
                   jcar.CarpackReader(str(path), force_python=True)]
        assert [r.native for r in readers] == [True, False, False]
        for r in readers:
            assert len(r) == len(recs)
            for i, rec in enumerate(recs):
                _equal_records(r[i], rec)
            with pytest.raises(IndexError):
                r[len(recs)]
            r.close()


def test_carpack_native_library_is_built_into_the_build_dir():
    lib = tcar._build_native()
    built = list(tcar._BUILD_DIR.glob("libcarpack-*.so"))
    assert built and lib is tcar._build_native()
    assert tcar._BUILD_DIR.name == "_build" and tcar._BUILD_DIR.parent.name == "controlar_tpu_torch"


def test_carpack_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "carpack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcar, "_SRC", bad)
    monkeypatch.setattr(tcar, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tcar, "_LIB", None)
    _write(tcar, tmp_path / "x.car", _records(1))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tcar.CarpackReader(str(tmp_path / "x.car"))
    assert tcar.CarpackReader(str(tmp_path / "x.car"), force_python=True).native is False


def test_pack_tree_matches_jax(t2i_tree, tmp_path):
    assert (tcar.pack_tree(t2i_tree, str(tmp_path / "port.car"))
            == jcar.pack_tree(t2i_tree, str(tmp_path / "jax.car")) == N)
    assert (tmp_path / "port.car").read_bytes() == (tmp_path / "jax.car").read_bytes()


@pytest.mark.parametrize("kind", ["t2i", "c2i"])
def test_pack_control_dataset_matches_jax_and_the_tree(t2i_tree, c2i_tree, tmp_path, kind):
    if kind == "t2i":
        kw = dict(code_path=t2i_tree, condition_type="canny", image_size=PX, get_prompt=True)
        tds = ttc.T2IControlCodeDataset(ttc.T2IControlConfig(**kw))
        jds = jtc.T2IControlCodeDataset(jtc.T2IControlConfig(**kw))
    else:
        args = (f"{c2i_tree}_codes", f"{c2i_tree}_labels", f"{c2i_tree}_canny_imagesnpy")
        tds, jds = (ttc.C2ICodeDataset(*args, flip_aug=False),
                    jtc.C2ICodeDataset(*args, flip_aug=False))
    n_t = tcar.pack_control_dataset(tds, str(tmp_path / "port.car"))
    n_j = jcar.pack_control_dataset(jds, str(tmp_path / "jax.car"))
    assert n_t == n_j == (N - 1 if kind == "t2i" else 5)  # the dummy item is skipped
    assert (tmp_path / "port.car").read_bytes() == (tmp_path / "jax.car").read_bytes()
    packed = tcar.CarpackControlDataset(str(tmp_path / "port.car"))
    jpacked = jcar.CarpackControlDataset(str(tmp_path / "jax.car"), force_python=True)
    assert packed.native and len(packed) == n_t
    dense = [i for i in range(len(tds)) if float(tds[i].get("valid", 1.0)) == 1.0]
    for j, i in enumerate(dense):
        _equal_items(packed[j], jpacked[j])
        if kind == "t2i":  # a 0-d field is stored with shape (1,), as the JAX writer does
            assert packed[j]["valid"].shape == (1,) and tds[i]["valid"].shape == ()
        want = dict(tds[i], valid=np.float32(1.0)) if "valid" not in tds[i] else tds[i]
        _equal_items(packed[j], want)


# --- label transforms --------------------------------------------------------


def _palette(k=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (k, 3)).astype(np.float64)


def test_map_color_to_index_matches_jax():
    pal = _palette(11)
    img = np.random.default_rng(1).random((2, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jlt.map_color_to_index(jnp.asarray(img), pal))
    np.testing.assert_array_equal(tlt.map_color_to_index(torch.from_numpy(img), pal).numpy(),
                                  want)


@pytest.mark.parametrize("hw,out", [((37, 53), (64, 64)), ((128, 96), (64, 48)),
                                    ((64, 64), 64), ((100, 100), (7, 13))])
def test_nearest_resize_matches_jax(hw, out):
    x = np.random.default_rng(2).integers(0, 200, (2, *hw)).astype(np.int64)
    np.testing.assert_array_equal(tlt.nearest_resize(torch.from_numpy(x), out).numpy(),
                                  np.asarray(jlt.nearest_resize(jnp.asarray(x), out)))


@pytest.mark.parametrize("hw,out", [((97, 83), (48, 64)), ((16, 20), (40, 30)),
                                    ((64, 64), (64, 64))])
def test_bilinear_resize_matches_jax(hw, out):
    x = np.random.default_rng(3).random((2, 1, *hw)).astype(np.float32)
    got = tlt.bilinear_resize(torch.from_numpy(x), out)
    assert got.shape == (2, 1, *out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jlt.bilinear_resize(jnp.asarray(x), out)),
                               atol=2e-3)


def test_seg_label_transforms_match_jax():
    pal = _palette(5)
    rng = np.random.default_rng(4)
    rgb = (pal[rng.integers(0, 5, (2, 20, 24))] / 255.0).transpose(0, 3, 1, 2).astype(np.float32)
    kw = dict(dataset_name=tlt.ADE20K_DATASET, output_size=(10, 12), palette=pal)
    want = np.asarray(jlt.seg_label_transform(jnp.asarray(rgb), **kw))
    got = tlt.seg_label_transform(torch.from_numpy(rgb), **kw)
    assert got.dtype == torch.int32 and (want == 255).any()
    np.testing.assert_array_equal(got.numpy(), want)
    idx = rng.integers(0, 30, (2, 20, 24)).astype(np.int64)
    want = np.asarray(jlt.label_transform(jnp.asarray(idx), "segmentation",
                                          tlt.COCOSTUFF_DATASET, output_size=(7, 9)))
    got = tlt.label_transform(torch.from_numpy(idx), "segmentation", tlt.COCOSTUFF_DATASET,
                              output_size=(7, 9))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tlt.seg_label_transform(torch.from_numpy(rgb), tlt.ADE20K_DATASET)
    with pytest.raises(NotImplementedError):
        tlt.label_transform(torch.from_numpy(idx), "flow")


def test_depth_and_edge_label_transforms_match_jax():
    x = np.random.default_rng(5).random((2, 30, 26)).astype(np.float32)
    for kw in ({}, {"output_size": (16, 12)}):
        want = np.asarray(jlt.label_transform(jnp.asarray(x), "depth", **kw))
        got = tlt.label_transform(torch.from_numpy(x), "depth", **kw).numpy()
        np.testing.assert_allclose(got, want, atol=2e-3)
    for task in ("canny", "lineart", "hed"):
        np.testing.assert_array_equal(tlt.label_transform(torch.from_numpy(x), task).numpy(), x)


@pytest.mark.parametrize("task", ["segmentation", "canny", "depth", "lineart", "hed"])
def test_reward_loss_matches_jax(task):
    rng = np.random.default_rng(6)
    if task == "segmentation":
        pred = rng.standard_normal((2, 5, 8, 8)).astype(np.float32)
        lab = rng.integers(0, 5, (2, 8, 8))
        lab[0, :3] = 255
    else:
        pred = rng.random((2, 3, 8, 8)).astype(np.float32)
        lab = rng.random((2, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jlt.reward_loss(jnp.asarray(pred), jnp.asarray(lab), task))
    got = tlt.reward_loss(torch.from_numpy(pred), torch.from_numpy(lab), task).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_group_random_crop_matches_jax():
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 255, (20 + i, 30 - i, 3)).astype(np.uint8) for i in range(4)]
    want = jlt.group_random_crop(imgs, (16, 18), np.random.default_rng(9))
    got = tlt.group_random_crop(imgs, (16, 18), np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tlt.group_random_crop(imgs, 64, np.random.default_rng(0))


# --- crops, image folders, ImageNet names ---------------------------------------


@pytest.mark.parametrize("size", [(90, 50), (300, 260), (64, 64)])
def test_crops_match_jax(size):
    img = Image.fromarray(np.random.default_rng(8).integers(0, 255, (*size[::-1], 3)
                                                             ).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(taug.center_crop_arr(img, 48)),
                                  np.asarray(jaug.center_crop_arr(img, 48)))
    a, b = random.Random(3), random.Random(3)
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(taug.random_crop_arr(img, 40, rng=a)),
                                      np.asarray(jaug.random_crop_arr(img, 40, rng=b)))


def test_image_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    for cls in ("b_cls", "a_cls"):
        os.makedirs(tmp_path / cls)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (12, 10, 3)).astype(np.uint8)).save(
                tmp_path / cls / f"{i}.png")
    for with_labels in (False, True):
        tds = tif.build_imagenet(str(tmp_path)) if with_labels else tif.build_coco(str(tmp_path))
        jds = jif.build_imagenet(str(tmp_path)) if with_labels else jif.build_coco(str(tmp_path))
        assert len(tds) == len(jds) == 4
        for i in range(4):
            _equal_items(tds[i], jds[i])
        _equal_items(tds.make_batch([tds[0], tds[3]]), jds.make_batch([jds[0], jds[3]]))
    for c in (1, 3, 4):
        x = rng.integers(0, 255, (9, 7, c) if c > 1 else (9, 7)).astype(np.uint8)
        np.testing.assert_array_equal(tif.hwc3(x), jif.hwc3(x))
    x = rng.integers(0, 255, (50, 70, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tif.resize_to_multiple(x, 128), jif.resize_to_multiple(x, 128))


def test_imagenet_names_match_jax():
    assert tlab.imagenet_classes() == jlab.imagenet_classes()
    assert len(tlab.imagenet_classes()) == 1000
    for q in ("goldfish", "1", "tiger shark", "great white shark"):
        assert tlab.lookup_class(q) == jlab.lookup_class(q)
    for q in ("zzzz", "1000", "great white"):
        with pytest.raises(ValueError):
            tlab.lookup_class(q)
    assert tlab.english_names(1) == jlab.english_names(1)
