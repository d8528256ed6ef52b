"""Importance-weighted aggregation (IWA) math (the port's own copy of
gava_clip_tpu/utils/aggregation.py; numpy, host math on an M x M Gram
matrix of M trained models).

Numpy rebuild of the aggregation core used by reference evaluation/iwa.py
(:200-322) and its truncated-SVD pseudoinverse (utils/aux_numpy.py:55-86):
per-model source-fit scalars F and target logit vectors G combine into
weights = pinv(G G^T / n) @ F; aggregated predictions are weight-averaged
text features (or logits).
"""

from typing import Sequence, Tuple

import numpy as np


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def onehot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    z = np.zeros((labels.size, n_classes), np.float32)
    z[np.arange(labels.size), labels] = 1
    return z


def truncated_pinv(a: np.ndarray, num_singular_values: int = -1,
                   rcond: float = 1e-1, hermitian: bool = False) -> np.ndarray:
    """Pseudoinverse with singular-value pruning: either keep values above
    rcond * s_max (num_singular_values == -1) or keep exactly the top-k
    (reference aux_numpy.pinv_with_singular_values)."""
    a = np.asarray(a).conjugate()
    u, s, vt = np.linalg.svd(a, full_matrices=False, hermitian=hermitian)
    cutoff = rcond * s.max(axis=-1, keepdims=True)
    if num_singular_values == -1:
        large = s > cutoff
    else:
        large = np.zeros_like(s, dtype=bool)
        large[:min(num_singular_values, len(s))] = True
    s_inv = np.divide(1.0, s, where=large, out=np.zeros_like(s))
    return vt.T @ (s_inv[..., None] * u.T)


def source_fit_stats(logits: np.ndarray, labels: np.ndarray,
                     n_classes: int) -> Tuple[np.ndarray, float]:
    """F matrix and scalar on the source (train) set: per-sample
    softmax(logits) * onehot(label); scalar = mean total true-class mass
    (reference iwa.py:216-242)."""
    f_mat = softmax(logits, axis=-1) * onehot(labels, n_classes)
    f_scalar = float((f_mat / f_mat.shape[0]).sum())
    return f_mat, f_scalar


def model_gram(g_vectors: Sequence[np.ndarray]) -> np.ndarray:
    """matrix_G[i, j] = mean over target samples of <g_i, g_j>
    (reference iwa.py:258-262)."""
    m = len(g_vectors)
    n = g_vectors[0].shape[0]
    gram = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            gram[i, j] = (g_vectors[i] * g_vectors[j]).sum(-1).sum(0) / n
    return gram


def aggregation_weights(g_vectors: Sequence[np.ndarray],
                        f_scalars: Sequence[float],
                        rcond: float = 1e-1,
                        num_singular_values: int = -1) -> np.ndarray:
    gram = model_gram(g_vectors)
    gram_inv = truncated_pinv(gram, num_singular_values=num_singular_values,
                              rcond=rcond)
    return gram_inv @ np.asarray(f_scalars)


def aggregate_text_features(weights: np.ndarray,
                            text_features: Sequence[np.ndarray]) -> np.ndarray:
    """Weighted mean of per-model (n_cls, E) text features
    (reference iwa.py:270-276)."""
    stacked = np.stack(text_features)                  # (M, n_cls, E)
    return (weights[:, None, None] * stacked).sum(0) / weights.sum()


def aggregate_logits(weights: np.ndarray,
                     g_vectors: Sequence[np.ndarray]) -> np.ndarray:
    """Weighted sum of per-model target logits (reference iwa.py:308-313)."""
    stacked = np.stack(g_vectors)                      # (M, N, n_cls)
    return (weights[:, None, None] * stacked).sum(0)
