"""The c2i sample evaluator: FID, sFID, Inception Score, precision and
recall (the JAX package's `eval/evaluator.py`, after the reference's TF
evaluator).

Given a reference batch npz and a sample batch npz (`arr_0`, NHWC uint8:
`eval/sampler.py`'s format), `evaluate_all` returns all five numbers. The
features come from the port's InceptionV3 (`eval/inception.py`) in
fixed-size batches on the card (bf16 by default, the tail batch padded and
cut); the precision / recall distance blocks are fp32 matmuls on the card.
The statistics, the Frechet distance and the Inception Score are float64
numpy on the host. A reference batch that carries mu / sigma / mu_s /
sigma_s is scored from those (no precision / recall then).

The radii take the nhood_size-th smallest distance of each row (self
included, clamped at 0); distances from a matmul in another order can
differ in their last bits, so a boundary comparison d <= r may differ from
another implementation's on near-ties.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.eval.inception import InceptionV3, inception_features
from controlar_tpu_torch.eval.metrics import frechet_distance


@dataclasses.dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6) -> float:
        return frechet_distance(self.mu, self.sigma, other.mu, other.sigma, eps)


def compute_statistics(acts: np.ndarray) -> FIDStatistics:
    return FIDStatistics(np.mean(acts, axis=0), np.cov(acts, rowvar=False))


def _batches(arr: np.ndarray, batch_size: int) -> Iterable[np.ndarray]:
    for i in range(0, len(arr), batch_size):
        yield arr[i: i + batch_size]


class Evaluator:
    """Activations and metrics over npz batches of images, on `device`
    ('cuda' unless the caller asks for 'cpu'; the Inception must be
    there)."""

    def __init__(self, inception: InceptionV3, batch_size: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        check_on(inception, self.device)
        self.model = inception
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype

    def compute_activations(self, images: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """images: NHWC uint8. -> (pool (N, 2048), spatial (N, 2023), logits
        (N, 1008)) float32, each batch padded to batch_size with zeros."""
        pools, spatials, logits = [], [], []
        bs = self.batch_size
        for batch in _batches(images, bs):
            n = len(batch)
            if n < bs:
                batch = np.concatenate([batch, np.zeros((bs - n, *batch.shape[1:]), batch.dtype)])
            p, s, l = inception_features(self.model, batch, self.compute_dtype)
            pools.append(p[:n].cpu().numpy())
            spatials.append(s[:n].cpu().numpy())
            logits.append(l[:n].cpu().numpy())
        return np.concatenate(pools), np.concatenate(spatials), np.concatenate(logits)

    @staticmethod
    def inception_score(logits: np.ndarray, split_size: int = 5000) -> float:
        """exp(E[KL(p(y|x) || p(y))]) per split of split_size, averaged;
        the softmax in fp32, the rest in float64."""
        preds = torch.softmax(torch.as_tensor(np.asarray(logits, np.float32)), dim=-1)
        preds = preds.double().numpy()
        scores = []
        for i in range(0, len(preds), split_size):
            part = preds[i: i + split_size]
            kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
            scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
        return float(np.mean(scores))

    def compute_prec_recall(self, ref_acts: np.ndarray, sample_acts: np.ndarray,
                            nhood_size: int = 3, row_batch: int = 10000,
                            col_batch: int = 10000) -> Tuple[float, float]:
        kw = dict(row_batch=row_batch, col_batch=col_batch, device=self.device)
        radii_ref = manifold_radii(ref_acts, nhood_size, **kw)
        radii_smp = manifold_radii(sample_acts, nhood_size, **kw)
        precision = manifold_fraction(ref_acts, radii_ref, sample_acts, **kw)
        recall = manifold_fraction(sample_acts, radii_smp, ref_acts, **kw)
        return precision, recall


def pairwise_sq_dists(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances |u|^2 - 2 u.v + |v|^2, fp32, clamped at 0
    (fp32 matmuls: keep TF32 off)."""
    nu = (u * u).sum(dim=1)[:, None]
    nv = (v * v).sum(dim=1)[None, :]
    return torch.clamp(nu - 2.0 * (u @ v.T) + nv, min=0.0)


def manifold_radii(feats: np.ndarray, nhood_size: int = 3, row_batch: int = 10000,
                   col_batch: int = 10000, device="cuda") -> np.ndarray:
    """The distance to each sample's nhood_size-th nearest neighbour (itself
    the 0th): the hypersphere radii."""
    dev = resolve_device(device)
    n = len(feats)
    f = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    radii = np.zeros((n,), np.float32)
    for r0 in range(0, n, row_batch):
        r1 = min(r0 + row_batch, n)
        dists = np.zeros((r1 - r0, n), np.float32)
        for c0 in range(0, n, col_batch):
            c1 = min(c0 + col_batch, n)
            dists[:, c0:c1] = pairwise_sq_dists(f[r0:r1], f[c0:c1]).cpu().numpy()
        radii[r0:r1] = np.partition(dists, nhood_size, axis=1)[:, nhood_size]
    return radii


def manifold_inside(feats: np.ndarray, radii: np.ndarray, eval_feats: np.ndarray,
                    row_batch: int = 10000, col_batch: int = 10000,
                    device="cuda") -> np.ndarray:
    """Whether each of eval_feats lies inside any hypersphere of (feats,
    radii): d <= r on the squared distances."""
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    e = torch.as_tensor(np.asarray(eval_feats, np.float32), device=dev)
    r = torch.as_tensor(np.asarray(radii, np.float32), device=dev)
    inside = np.zeros((len(eval_feats),), bool)
    for r0 in range(0, len(eval_feats), row_batch):
        r1 = min(r0 + row_batch, len(eval_feats))
        hit = torch.zeros(r1 - r0, dtype=torch.bool, device=dev)
        for c0 in range(0, len(feats), col_batch):
            c1 = min(c0 + col_batch, len(feats))
            hit |= (pairwise_sq_dists(e[r0:r1], f[c0:c1]) <= r[None, c0:c1]).any(dim=1)
        inside[r0:r1] = hit.cpu().numpy()
    return inside


def manifold_fraction(feats: np.ndarray, radii: np.ndarray, eval_feats: np.ndarray,
                      row_batch: int = 10000, col_batch: int = 10000,
                      device="cuda") -> float:
    """The fraction of eval_feats inside any hypersphere of (feats, radii)."""
    return float(np.mean(manifold_inside(feats, radii, eval_feats, row_batch, col_batch,
                                         device)))


def load_batch(npz_path: str) -> np.ndarray:
    with np.load(npz_path) as obj:
        return obj["arr_0"]


def _maybe_precomputed_stats(npz_path: str
                             ) -> Optional[Tuple[FIDStatistics, FIDStatistics]]:
    with np.load(npz_path) as obj:
        if "mu" in obj.files:
            return (FIDStatistics(obj["mu"], obj["sigma"]),
                    FIDStatistics(obj["mu_s"], obj["sigma_s"]))
    return None


def evaluate_all(inception: InceptionV3, ref_npz: str, sample_npz: str, batch_size: int = 64,
                 device="cuda") -> Dict[str, float]:
    """inception_score, fid and sfid, and precision and recall unless the
    reference npz carries its statistics."""
    ev = Evaluator(inception, batch_size=batch_size, device=device)
    sample_pool, sample_spatial, sample_logits = ev.compute_activations(load_batch(sample_npz))
    pre = _maybe_precomputed_stats(ref_npz)
    if pre is not None:
        ref_stats, ref_stats_sp = pre
        ref_pool = None
    else:
        ref_pool, ref_spatial, _ = ev.compute_activations(load_batch(ref_npz))
        ref_stats = compute_statistics(ref_pool)
        ref_stats_sp = compute_statistics(ref_spatial)
    out = {
        "inception_score": ev.inception_score(sample_logits),
        "fid": compute_statistics(sample_pool).frechet_distance(ref_stats),
        "sfid": compute_statistics(sample_spatial).frechet_distance(ref_stats_sp),
    }
    if ref_pool is not None:
        out["precision"], out["recall"] = ev.compute_prec_recall(ref_pool, sample_pool)
    return out
