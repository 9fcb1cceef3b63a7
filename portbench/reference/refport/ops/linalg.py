"""Small-matrix dense linear algebra for the physics pipeline.

Counterpart of ``puppax/ops/linalg.py``: the same left-looking Cholesky
built column by column, and the same forward and back substitutions, so
that rounding follows the JAX package's order. Every function takes
tensors with any leading batch axes (the env axis ``B``) in front of the
matrix axes; there is no kernel here, only plain tensor code.
"""

from __future__ import annotations

import torch


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x for small (..., n, m) A and (..., m) x, as a multiply-reduce."""
    return torch.sum(A * x[..., None, :], dim=-1)


def mtv(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A.T @ y for small (..., n, m) A and (..., n) y."""
    return torch.sum(A * y[..., :, None], dim=-2)


def cholesky_columns(A: torch.Tensor) -> list:
    """Columns of the lower Cholesky factor of a small SPD (..., n, n).

    ``A`` must be symmetric (rows are read in place of columns). Returns a
    list of n tensors of shape (..., n)."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    cols = []
    for k in range(n):
        acc = A[..., k, :]  # row k == column k by symmetry
        for j in range(k):
            acc = acc - cols[j][..., k, None] * cols[j]
        pivot = torch.sqrt(torch.clamp_min(acc[..., k], 1e-30))
        col = acc / pivot[..., None]
        cols.append(torch.where(idx >= k, col, zero))
    return cols


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a small SPD matrix (unrolled)."""
    return torch.stack(cholesky_columns(A), dim=-1)


def _solve_lower_cols(cols: list, b: torch.Tensor) -> list:
    """Forward substitution L y = b on the column representation."""
    ys = []
    for k in range(len(cols)):
        acc = b[..., k]
        for j in range(k):
            acc = acc - cols[j][..., k] * ys[j]
        ys.append(acc / cols[k][..., k])
    return ys


def _solve_upper_t_cols(cols: list, ys: list) -> torch.Tensor:
    """Back substitution L^T x = y on the column representation."""
    n = len(cols)
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        acc = ys[k]
        for j in range(n - 1, k, -1):
            acc = acc - cols[k][..., j] * xs[j]
        xs[k] = acc / cols[k][..., k]
    return torch.stack(xs, dim=-1)


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b with L lower triangular."""
    cols = [L[..., :, k] for k in range(L.shape[-1])]
    return torch.stack(_solve_lower_cols(cols, b), dim=-1)


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y with L lower triangular."""
    n = L.shape[-1]
    cols = [L[..., :, k] for k in range(n)]
    return _solve_upper_t_cols(cols, [y[..., k] for k in range(n)])


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = cholesky(A)."""
    return solve_upper_t(L, solve_lower(L, b))


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a small SPD system A x = b by the unrolled Cholesky (column
    vectors end to end, the factor never stacked)."""
    cols = cholesky_columns(A)
    return _solve_upper_t_cols(cols, _solve_lower_cols(cols, b))
