"""Accuracy: top-1 of ``(N, C)`` scores (the first of equal maxima), or
scores at or above 0.5 for ``(N,)`` binary scores, against the labels."""
import numpy as np
import torch


def reference(preds: torch.Tensor, target: torch.Tensor, kwargs: dict) -> np.ndarray:
    if kwargs:
        raise ValueError(f"the Accuracy reference takes no arguments, got {kwargs}")
    if preds.ndim == 2:
        # the first of equal maxima, whatever argmax's own rule
        best = preds.max(dim=1, keepdim=True).values
        column = torch.arange(preds.shape[1], device=preds.device)
        predicted = torch.where(preds == best, column, preds.shape[1]).min(dim=1).values
    else:
        predicted = (preds >= 0.5).to(torch.int64)
    hits = int(torch.count_nonzero(predicted == target))
    return np.array([hits / float(target.numel())], dtype=np.float64)
