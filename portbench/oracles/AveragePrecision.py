"""Average precision with tie groups: binary (``pos_label``), or each of
``num_classes`` one-vs-rest, as a per-class array."""
import numpy as np
import torch

from portbench.oracles._ranking import auroc_ap_rows, one_vs_rest


def reference(preds: torch.Tensor, target: torch.Tensor, kwargs: dict) -> np.ndarray:
    if preds.ndim == 1:
        rel = (target == kwargs.get("pos_label", 1)).reshape(1, -1)
        return auroc_ap_rows(preds.reshape(1, -1), rel)[1].cpu().numpy()
    return auroc_ap_rows(preds.T, one_vs_rest(target, int(kwargs["num_classes"])))[1].cpu().numpy()
