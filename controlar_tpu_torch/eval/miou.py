"""Segmentation-consistency mIoU: the confusion-matrix mIoU between the
labels a segmenter predicts on generated images and the ground-truth label
maps (the JAX package's `eval/miou.py`, after the reference's
evaluations/ade20k_mIoU.py and cocostuff_mIoU.py).

The reference scores with mmseg reward models (Mask2Former-SwinL for
ADE20K-150, DeepLabV3-R101 for COCOStuff-171; `convert_mmseg.py`); any
callable `segmenter(images_u8) -> (B, H, W) int labels` will do. The metric
is numpy on the host and exact.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, gt: np.ndarray, pred: np.ndarray):
        gt = np.asarray(gt).ravel()
        pred = np.asarray(pred).ravel()
        keep = (gt != self.ignore_index) & (gt < self.num_classes)
        gt, pred = gt[keep], pred[keep]
        idx = gt.astype(np.int64) * self.num_classes + pred.astype(np.int64)
        self.mat += np.bincount(
            idx, minlength=self.num_classes ** 2
        ).reshape(self.num_classes, self.num_classes)

    def miou(self) -> Tuple[float, np.ndarray]:
        tp = np.diag(self.mat).astype(np.float64)
        fp = self.mat.sum(0) - tp
        fn = self.mat.sum(1) - tp
        denom = tp + fp + fn
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
        return float(np.nanmean(iou)), iou


def miou_eval(
    segmenter: Callable[[np.ndarray], np.ndarray],
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    ignore_index: int = 255,
) -> float:
    """pairs: iterable of (generated uint8 RGB batch, gt label batch)."""
    cm = ConfusionMatrix(num_classes, ignore_index)
    for images, labels in pairs:
        preds = segmenter(images)
        cm.update(labels, preds)
    return cm.miou()[0]


# --- reference-exact protocol ------------------------------------------------
# The class above is the clean formulation; the functions below reproduce the
# reference scripts' exact accounting — including their quirks — so numbers
# are comparable with the paper's tables.


def reference_confusion_update(
    conf: np.ndarray,
    pred: np.ndarray,
    gt: np.ndarray,
    num_classes: int,
    ignore_label: int,
    pred_offset: int = 0,
) -> None:
    """One image's update of the (K+1, K+1) matrix, exactly as the reference
    does it (ref evaluations/ade20k_mIoU.py:42-50 / cocostuff_mIoU.py:45-54):
    rows are predictions, cols are ground truth, gt==ignore_label is remapped
    to the extra class K, and ADE20K predictions are shifted +1 onto the
    1-based annotation space before binning."""
    gt = np.asarray(gt).copy()
    pred = np.asarray(pred).astype(np.int64) + pred_offset
    gt[gt == ignore_label] = num_classes
    conf += np.bincount(
        (num_classes + 1) * pred.reshape(-1) + gt.reshape(-1),
        minlength=conf.size,
    ).reshape(conf.shape)


def reference_miou(conf: np.ndarray, num_classes: int) -> float:
    """mIoU from the (K+1, K+1) matrix, exactly ref ade20k_mIoU.py:54-66.

    Quirk preserved: the numerator sums IoU over classes present in gt
    (pos_gt > 0) while the denominator counts classes present in gt OR
    predictions (pos_gt + pos_pred > 0), so hallucinated classes dilute the
    mean without contributing IoU."""
    iou = np.full(num_classes, np.nan, dtype=np.float64)
    tp = conf.diagonal()[:-1].astype(np.float64)
    pos_gt = np.sum(conf[:-1, :-1], axis=0).astype(np.float64)
    pos_pred = np.sum(conf[:-1, :-1], axis=1).astype(np.float64)
    acc_valid = pos_gt > 0
    iou_valid = (pos_gt + pos_pred) > 0
    union = pos_gt + pos_pred - tp
    iou[acc_valid] = tp[acc_valid] / union[acc_valid]
    return float(np.sum(iou[acc_valid]) / np.sum(iou_valid))


def ade20k_miou(segmenter, pairs) -> float:
    """ADE20K-150 protocol (ref evaluations/ade20k_mIoU.py): gt annotations
    are 1-based with 0 = ignore; model classes 0..149 are shifted +1."""
    num_classes = 150
    conf = np.zeros((num_classes + 1, num_classes + 1), np.int64)
    for images, labels in pairs:
        preds = segmenter(images)
        for p, g in zip(preds, labels):
            reference_confusion_update(conf, p, g, num_classes,
                                       ignore_label=0, pred_offset=1)
    return reference_miou(conf, num_classes)


def cocostuff_miou(segmenter, pairs) -> float:
    """COCOStuff-171 protocol (ref evaluations/cocostuff_mIoU.py): labels are
    0-based with 255 = ignore; predictions used as-is."""
    num_classes = 171
    conf = np.zeros((num_classes + 1, num_classes + 1), np.int64)
    for images, labels in pairs:
        preds = segmenter(images)
        for p, g in zip(preds, labels):
            reference_confusion_update(conf, p, g, num_classes,
                                       ignore_label=255, pred_offset=0)
    return reference_miou(conf, num_classes)
