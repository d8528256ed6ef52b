"""Metric definitions reproduced exactly from the reference training script
(the port's own copy of gava_clip_tpu/train/metrics.py):
macro-F1 with +1e-8 guard (train.py:538-541), weighted F1 (train.py:619-628),
precision/recall as nanmean of confusion-matrix ratios (train.py:625-626)."""

from typing import Dict

import numpy as np


def f1_from_confusion(conf_mat: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    c = conf_mat.shape[0]
    f1 = np.zeros(c)
    for ci in range(c):
        f1[ci] = 2 * conf_mat[ci, ci] / (conf_mat[ci, :].sum()
                                         + conf_mat[:, ci].sum() + eps)
    return f1


def summary_from_confusion(conf_mat: np.ndarray) -> Dict[str, object]:
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.zeros(conf_mat.shape[0])
        wf1 = np.zeros(conf_mat.shape[0])
        weights = conf_mat.sum(axis=1) / conf_mat.sum()
        for ci in range(conf_mat.shape[0]):
            denom = conf_mat[ci, :].sum() + conf_mat[:, ci].sum()
            f1[ci] = 2 * conf_mat[ci, ci] / denom if denom else np.nan
            wf1[ci] = f1[ci] * weights[ci]
        precision = np.nanmean(np.diag(conf_mat) / conf_mat.sum(axis=0))
        recall = np.nanmean(np.diag(conf_mat) / conf_mat.sum(axis=1))
    f1 = np.nan_to_num(f1, nan=0.0)
    wf1 = np.nan_to_num(wf1, nan=0.0)
    acc = np.trace(conf_mat) / max(conf_mat.sum(), 1)
    return {
        "accuracy": float(acc),
        "f1_per_class": f1,
        "f1_mean": float(f1.mean()),
        "wf1_per_class": wf1,
        "wf1_sum": float(wf1.sum()),
        "precision": float(precision),
        "recall": float(recall),
    }


class StepAnomalyDetector:
    """Lightweight failure detection for the train loop: flags non-finite
    losses and step-time outliers (> k x the running median). The reference
    has no failure detection (SURVEY.md §5); this plus checkpoint rollback
    forms the recovery story."""

    def __init__(self, slow_factor: float = 5.0, window: int = 50):
        self.slow_factor = slow_factor
        self.times = []
        self.window = window

    def check_loss(self, loss_value: float) -> bool:
        """True if the loss is usable; False on NaN/inf."""
        return bool(np.isfinite(loss_value))

    def check_step_time(self, seconds: float):
        """Returns a warning string for outlier steps, else None."""
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 10:
            med = float(np.median(self.times))
            if seconds > self.slow_factor * med:
                return (f"step took {seconds:.2f}s "
                        f"({seconds / med:.1f}x the median {med:.2f}s)")
        return None
