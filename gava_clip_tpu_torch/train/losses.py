"""Loss functions (port of gava_clip_tpu/train/losses.py). All plain tensor
code; per-sample reductions are left to the caller."""

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross entropy with integer labels
    (`CrossEntropyLoss(reduction='none')`). The memory head feeds
    already-log-softmaxed logits through this too, applying log_softmax
    again, which this reproduces by construction."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def focal_ordinal_weight(logits: torch.Tensor, labels: torch.Tensor,
                         gamma: float = 2.0, alpha: float = 0.25,
                         beta: float = 0.0, scale: float = 1.0
                         ) -> torch.Tensor:
    """Per-sample weight combining a focal term and the ordinal distance
    |argmax(y) - argmax(y_hat)| / (C-1)."""
    n_cls = logits.shape[-1]
    y_true = F.one_hot(labels.long(), n_cls).float()
    y_pred = torch.softmax(logits.float(), dim=-1)
    ordinal = (labels.long() - y_pred.argmax(dim=-1)).abs().float()
    weights = ordinal / (n_cls - 1)
    focal = alpha * torch.pow(1.0 - y_pred, gamma)
    combined = (beta * weights[:, None] + focal) * y_true
    return combined.sum(-1) * scale


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       use_focal: bool = False, scale: float = 1.0
                       ) -> torch.Tensor:
    """SigLIP-style +-1 log-sigmoid loss, summed over classes per sample."""
    n_cls = logits.shape[-1]
    if labels.dim() == logits.dim() - 1:
        y = F.one_hot(labels.long(), n_cls).float()
    else:
        y = labels.float()
    z = logits.float()
    ce = -F.logsigmoid((y * 2.0 - 1.0) * z)
    if use_focal:
        p = torch.sigmoid(z)
        p_t = p * y + (1.0 - p) * (1.0 - y)
        a_t = alpha * y + (1.0 - alpha) * (1.0 - y)
        ce = a_t * (1.0 - p_t) ** gamma * ce
    return ce.sum(-1) * scale


def cosine_similarity_nce(sim_mat: torch.Tensor, temperature: float = 10.0,
                          weight: float = 1.0) -> torch.Tensor:
    """Cosine-similarity NCE over a square similarity matrix, mean
    reduction."""
    nomin = torch.exp(torch.diagonal(sim_mat, dim1=-2, dim2=-1) / temperature)
    denomin = torch.exp(sim_mat.sum(-1) / temperature)
    return weight * torch.mean(-torch.log(nomin / denomin))


def info_nce(y_pred: torch.Tensor, y_true: torch.Tensor, n_cls: int,
             temperature: float = 0.1, weight: float = 1.0,
             eps: float = 1e-7, focal: bool = False) -> torch.Tensor:
    """InfoNCE over class logits (the y=None path of the original)."""
    onehot = F.one_hot(y_true.long(), n_cls).bool()
    pair_pos = y_pred[onehot]
    prob_pos = torch.exp(pair_pos / temperature)
    prob_neg = torch.exp(y_pred / temperature)
    if focal:
        fw = 0.25 * torch.pow(1.0 - prob_pos / prob_neg.sum(-1), 2.0)
        prob_pos = prob_pos * fw
    return weight * (-torch.log(prob_pos.sum() / (prob_neg.sum() + eps)))
