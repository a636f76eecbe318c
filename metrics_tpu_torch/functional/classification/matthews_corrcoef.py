"""Matthews correlation coefficient (functional). Port of ``metrics_tpu/functional/classification/matthews_corrcoef.py``.

The formula is the JAX package's, in float32: ``c·s − Σ tk·pk`` over
``sqrt(s² − Σ pk²) · sqrt(s² − Σ tk²)``. At large ``s`` the differences
cancel, so the value drifts from a float64 evaluation of the same counts.
"""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: torch.Tensor) -> torch.Tensor:
    tk = torch.sum(confmat, dim=0).to(torch.float32)
    pk = torch.sum(confmat, dim=1).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = torch.sum(confmat).to(torch.float32)
    return (c * s - torch.sum(tk * pk)) / (
        torch.sqrt(s**2 - torch.sum(pk * pk)) * torch.sqrt(s**2 - torch.sum(tk * tk))
    )


def matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> torch.Tensor:
    r"""Matthews correlation coefficient from the confusion-matrix marginals.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef(preds, target, num_classes=2)
        tensor(0.5774)
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
