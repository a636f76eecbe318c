"""AUROC with tie groups: binary (``pos_label``), or one-vs-rest over
``num_classes``, averaged by ``average`` (``"macro"``, or None for the
per-class values)."""
import numpy as np
import torch

from portbench.oracles._ranking import auroc_ap_rows, one_vs_rest


def reference(preds: torch.Tensor, target: torch.Tensor, kwargs: dict) -> np.ndarray:
    if preds.ndim == 1:
        per_class = auroc_ap_rows(preds.reshape(1, -1), (target == kwargs.get("pos_label", 1)).reshape(1, -1))[0]
        return per_class.cpu().numpy()
    per_class = auroc_ap_rows(preds.T, one_vs_rest(target, int(kwargs["num_classes"])))[0].cpu().numpy()
    average = kwargs.get("average", "macro")
    if average == "macro":
        return np.array([per_class.mean()])
    if average is None:
        return per_class
    raise ValueError(f"the AUROC reference has no average {average!r}")
