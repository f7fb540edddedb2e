"""The generator: the same seed gives the same inputs; another seed the same
sizes in another order."""
import numpy as np
import pytest
import torch

from portbench.harness import traffic as tr
from portbench.tests import tiny

BIG = 2 ** 32 + 17  # more than 32 signed bits


def test_images_labels_and_seeds_repeat():
    for seed in (0, BIG):
        assert np.array_equal(tr.condition_images(3, 64, seed, "gen", 1),
                              tr.condition_images(3, 64, seed, "gen", 1))
        assert np.array_equal(tr.labels(5, 1000, seed, "gen", 2), tr.labels(5, 1000, seed, "gen", 2))
        assert tr.torch_seed(seed, "gen_call", 4) == tr.torch_seed(seed, "gen_call", 4)
    assert not np.array_equal(tr.condition_images(3, 64, 1, "gen", 1),
                              tr.condition_images(3, 64, 2, "gen", 1))


def test_caption_lengths_spread_and_masks():
    g = tiny.gpt("t2i")
    emb, mask = tr.captions(6, g, 2, 8, BIG, "cpu", "x")
    emb2, mask2 = tr.captions(6, g, 2, 8, BIG, "cpu", "x")
    assert torch.equal(emb, emb2) and np.array_equal(mask, mask2)
    assert sorted(mask.sum(1)) == sorted(np.rint(np.linspace(2, 8, 6)).astype(int))
    assert mask[:, -1].all()  # left padding: the last column always valid
    assert torch.all(emb.float()[torch.as_tensor(~mask)] == 0)
    _, other = tr.captions(6, g, 2, 8, 5, "cpu", "x")
    assert sorted(other.sum(1)) == sorted(mask.sum(1))


def test_train_batches_repeat_and_differ_by_index():
    g = tiny.gpt("t2i")
    a, b = tr.train_batch(g, 4, 64, 2, 8, BIG, 0), tr.train_batch(g, 4, 64, 2, 8, BIG, 0)
    for k in a:
        assert np.array_equal(a[k], b[k])
    c = tr.train_batch(g, 4, 64, 2, 8, BIG, 1)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["caption_emb"],
                          torch.from_numpy(a["caption_emb"]).bfloat16().float().numpy())
