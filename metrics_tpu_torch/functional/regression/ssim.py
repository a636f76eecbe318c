"""Structural similarity index. Port of ``metrics_tpu/functional/regression/ssim.py``.

The five SSIM moment maps (``mu_p, mu_t, E[p^2], E[t^2], E[pt]``) come from
two separable 1-d Gaussian passes over one ``(5B, C, H, W)`` stack: the
window is rank-1, so a k×k blur factors exactly into a k-tap pass over H
and one over W. Windows are VALID (only fully interior SSIM values enter
the reduction), which equals the reference's reflect-pad, blur and crop.

Each pass is a banded matrix product (``torch.matmul``, cuBLAS) when
``max(H, W) <= _MATMUL_BLUR_MAX_DIM``, else a depthwise ``F.conv2d`` with
``groups=C`` (cuDNN): the JAX package's split. Both run at full float32
precision whatever the caller's global flags say: TF32 operand rounding
(cuDNN's default for convolutions, and matmuls' under
``torch.set_float32_matmul_precision("high")``) moves the SSIM index by
about 6e-5. :func:`_full_float32` sets the flags for the blur alone and
restores the caller's.
"""
import functools
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.distributed import reduce


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1, dtype=dtype, device=device)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return gauss / gauss.sum()  # (kernel_size,)


# above this spatial extent the banded product's O(H) multiply-adds per
# output outgrow the convolution's O(k) (the JAX package's split, kept)
_MATMUL_BLUR_MAX_DIM = 512


@functools.lru_cache(maxsize=64)
def _blur_matrix(n: int, k: int, sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Banded ``(n-k+1, n)`` matrix applying a VALID k-tap Gaussian pass,
    built on ``device`` (no host copy) and cached per its arguments."""
    g = _gaussian(k, sigma, dtype, device)
    out = n - k + 1
    idx = torch.arange(out, device=device)[:, None] + torch.arange(k, device=device)[None, :]
    return torch.zeros((out, n), dtype=dtype, device=device).scatter_(1, idx, g.expand(out, k))


@contextmanager
def _full_float32():
    """Full float32 matmuls and convolutions (no TF32) inside; the caller's
    flags read the same afterwards."""
    matmul = torch.get_float32_matmul_precision()
    conv = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


def _depthwise_blur(stack: torch.Tensor, kernel_size: Sequence[int], sigma: Sequence[float]) -> torch.Tensor:
    """Separable Gaussian blur of an ``(N, C, H, W)`` stack, VALID windows:
    a pass over H, then one over W (module docstring)."""
    h, w = stack.shape[2], stack.shape[3]
    with _full_float32():
        if max(h, w) <= _MATMUL_BLUR_MAX_DIM:
            gh = _blur_matrix(h, kernel_size[0], float(sigma[0]), stack.dtype, stack.device)
            stack = torch.matmul(gh, stack)
            gw = _blur_matrix(w, kernel_size[1], float(sigma[1]), stack.dtype, stack.device)
            return torch.matmul(stack, gw.T)

        channel = stack.shape[1]
        for axis, (k, s) in enumerate(zip(kernel_size, sigma)):
            g = _gaussian(k, s, stack.dtype, stack.device)
            shape = (channel, 1, k, 1) if axis == 0 else (channel, 1, 1, k)
            stack = F.conv2d(stack, g.reshape(shape[2:]).expand(shape).contiguous(), groups=channel)
        return stack


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ssim_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got pred: {_dtype_name(preds.dtype)} and target: {_dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got pred: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )

    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")

    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        # a 0-d tensor on the device: no host read
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    batch = preds.shape[0]
    # five moment maps from two separable passes over one stack
    stack = torch.cat((preds, target, preds * preds, target * target, preds * target))
    blurred = _depthwise_blur(stack, kernel_size, sigma)
    mu_p, mu_t, e_pp, e_tt, e_pt = (blurred[x * batch:(x + 1) * batch] for x in range(5))

    mu_pred_sq = mu_p ** 2
    mu_target_sq = mu_t ** 2
    mu_pred_target = mu_p * mu_t

    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    return reduce(ssim_idx, reduction)


def ssim(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Computes Structural Similarity Index Measure.

    Args:
        preds: estimated image
        target: ground truth image
        kernel_size: size of the gaussian kernel.
        sigma: standard deviation of the gaussian kernel.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``.
        data_range: range of the image; if None, determined from the images.
        k1: first SSIM stability constant.
        k2: second SSIM stability constant.

    Example:
        >>> gen = torch.Generator().manual_seed(42)
        >>> preds = torch.rand((16, 1, 16, 16), generator=gen)
        >>> target = preds * 0.75
        >>> float(ssim(preds, target)) > 0.91
        True
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)
