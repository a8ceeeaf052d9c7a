"""Evaluation metrics: AUC (rank-based Mann-Whitney), logloss and accuracy.

Ties get average ranks (matches sklearn on CTR data). Both run on whatever
device their inputs lie on; the evaluation loop hands them CPU tensors.
"""
from __future__ import annotations

import torch


def logloss(labels: torch.Tensor, probs: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    p = torch.clamp(probs, eps, 1 - eps)
    return -torch.mean(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))


def auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Mann-Whitney U AUC with average-rank tie handling."""
    labels = labels.to(torch.float32).reshape(-1)
    scores = scores.to(torch.float32).reshape(-1)
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    sorted_scores = scores[order]
    sorted_labels = labels[order]
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)
    # average ranks for ties: group equal scores, mean rank per group
    is_new = torch.cat([torch.ones((1,), dtype=torch.bool, device=scores.device),
                        sorted_scores[1:] != sorted_scores[:-1]])
    group_id = torch.cumsum(is_new, 0) - 1
    group_sum = torch.zeros_like(ranks).index_add_(0, group_id, ranks)
    group_cnt = torch.zeros_like(ranks).index_add_(0, group_id,
                                                   torch.ones_like(ranks))
    avg_rank = (group_sum / torch.clamp(group_cnt, min=1.0))[group_id]
    n_pos = torch.sum(sorted_labels)
    n_neg = n - n_pos
    sum_pos_ranks = torch.sum(avg_rank * sorted_labels)
    u = sum_pos_ranks - n_pos * (n_pos + 1) / 2.0
    return torch.where((n_pos == 0) | (n_neg == 0), 0.5,
                       u / torch.clamp(n_pos * n_neg, min=1.0))


def binary_accuracy(labels: torch.Tensor, probs: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    """The float32 share of thresholded probabilities (``probs >
    threshold``: a tie counts as 0) equal to the labels. The count is
    multiplied by the float32 reciprocal of the size, as the reference's
    mean is on the CPU (a division rounds differently for ~1 size in 4)."""
    hits = ((probs > threshold).to(torch.float32) == labels).to(torch.float32)
    return torch.sum(hits) * torch.tensor(1.0 / hits.numel(),
                                          dtype=torch.float32,
                                          device=hits.device)
