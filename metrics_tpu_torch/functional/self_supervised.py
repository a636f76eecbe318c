"""Embedding similarity matrix.

Port of ``metrics_tpu/functional/self_supervised.py``. The pairwise product
is one ``(B, D) @ (D, B)`` ``torch.matmul``, run at full float32 whatever
the caller's TF32 flags (the JAX package pins ``HIGHEST`` precision: a
reduced-precision product moves cosine similarities by about 1e-3); the
caller's flags read the same afterwards.
"""
import torch

from metrics_tpu_torch.functional.regression.ssim import _full_float32


def embedding_similarity(
    batch: torch.Tensor,
    similarity: str = "cosine",
    reduction: str = "none",
    zero_diagonal: bool = True,
) -> torch.Tensor:
    """Computes pairwise representation similarity of a ``(batch, dim)`` tensor.

    Args:
        batch: (batch, dim)
        similarity: 'dot' or 'cosine'
        reduction: 'none', 'sum', 'mean' (all along dim -1)
        zero_diagonal: if True, the diagonal is set to zero

    Return:
        A ``(batch, batch)`` similarity matrix, or ``(batch,)`` when reduced.

    Example:
        >>> embeddings = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.], [4., 5., 6., 7.]])
        >>> torch.round(embedding_similarity(embeddings), decimals=4)
        tensor([[0.0000, 1.0000, 0.9759],
                [1.0000, 0.0000, 0.9759],
                [0.9759, 0.9759, 0.0000]])
    """
    if similarity == "cosine":
        norm = torch.linalg.vector_norm(batch, ord=2, dim=1)
        batch = batch / norm[:, None]

    with _full_float32():
        sqr_mtx = torch.matmul(batch, batch.T)

    if zero_diagonal:
        sqr_mtx = sqr_mtx * (1 - torch.eye(batch.shape[0], dtype=batch.dtype, device=batch.device))

    if reduction == "mean":
        sqr_mtx = torch.mean(sqr_mtx, dim=-1)
    if reduction == "sum":
        sqr_mtx = torch.sum(sqr_mtx, dim=-1)

    return sqr_mtx
