"""Image gradients by finite differences.

Port of ``metrics_tpu/functional/image_gradients.py``: 1-step forward
differences along H and W, zero at the far edge, on the image's device.
"""
from typing import Tuple

import torch


def _image_gradients_validate(img) -> None:
    """Validates whether img is a 4D tensor."""
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <torch.Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-step forward differences, zero-padded at the far edge."""
    dy = torch.zeros_like(img)
    dx = torch.zeros_like(img)
    dy[..., :-1, :] = img[..., 1:, :] - img[..., :-1, :]
    dx[..., :, :-1] = img[..., :, 1:] - img[..., :, :-1]
    return dy, dx


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Computes image gradients (dy, dx) of an ``(N, C, H, W)`` image batch.

    The gradient ``I(x+1, y) - I(x, y)`` is stored at location ``(x, y)``
    (1-step finite difference, the TF convention); the last row of ``dy``
    and the last column of ``dx`` are 0.

    Example:
        >>> image = torch.arange(0, 1 * 1 * 5 * 5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, :]
        tensor([[5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [0., 0., 0., 0., 0.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
