"""Linear-algebra ops (counterpart of ``mxnet_tpu/ops/linalg.py``,
reference ``src/operator/tensor/la_op.cc``) on ``torch.linalg`` and
``torch.matmul``: LAPACK on the CPU, cuSOLVER and cuBLAS on the card.
None of them is a hand-written kernel in the JAX package either (XLA's
decompositions there).  The reference's ``_linalg_*`` names and their
aliases are kept.

Every op works on the last two axes and batches over the leading ones.
``gelqf``, ``syevd`` and ``svd`` return factors whose vectors carry a
sign each that LAPACK, cuSOLVER and XLA may choose differently: compare
them by what they reconstruct.
"""
from __future__ import annotations

import torch

from ..base import attr_truthy
from .registry import register

__all__ = []


def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm", nin=3, aliases=["linalg_gemm"])
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):
    a = _t(A) if attr_truthy(transpose_a) else A
    b = _t(B) if attr_truthy(transpose_b) else B
    return float(alpha) * torch.matmul(a, b) + float(beta) * C


@register("_linalg_gemm2", nin=2, aliases=["linalg_gemm2"])
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    a = _t(A) if attr_truthy(transpose_a) else A
    b = _t(B) if attr_truthy(transpose_b) else B
    return float(alpha) * torch.matmul(a, b)


@register("_linalg_potrf", nin=1, aliases=["linalg_potrf"])
def _potrf(A):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", nin=1, aliases=["linalg_potri"])
def _potri(A):
    """inv(L·Lᵀ) from the lower Cholesky factor ``A``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trsm", nin=2, aliases=["linalg_trsm"])
def _trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """alpha·op(A)⁻¹·B (or B·op(A)⁻¹ with ``rightside``), reading only
    the ``lower`` (or upper) triangle of A."""
    transpose = attr_truthy(transpose)
    a = _t(A) if transpose else A
    low = attr_truthy(lower) != transpose
    out = torch.linalg.solve_triangular(
        a, B, upper=not low, left=not attr_truthy(rightside))
    return float(alpha) * out


@register("_linalg_trmm", nin=2, aliases=["linalg_trmm"])
def _trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    tri = torch.tril(A) if attr_truthy(lower) else torch.triu(A)
    a = _t(tri) if attr_truthy(transpose) else tri
    out = torch.matmul(B, a) if attr_truthy(rightside) else torch.matmul(a, B)
    return float(alpha) * out


@register("_linalg_syrk", nin=1, aliases=["linalg_syrk"])
def _syrk(A, transpose=False, alpha=1.0):
    a = _t(A) if attr_truthy(transpose) else A
    return float(alpha) * torch.matmul(a, _t(a))


@register("_linalg_gelqf", nin=1, nout=2, aliases=["linalg_gelqf"])
def _gelqf(A):
    """(L, Q) with A = L·Q, Q's rows orthonormal: the QR factors of Aᵀ,
    transposed."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_syevd", nin=1, nout=2, aliases=["linalg_syevd"])
def _syevd(A):
    """(U, w): the eigenvectors as U's rows and the eigenvalues
    ascending.  The input is symmetrised first, as ``jnp.linalg.eigh``
    does, so its gradient is symmetric as there."""
    w, v = torch.linalg.eigh((A + _t(A)) / 2)
    return _t(v), w


@register("_linalg_sumlogdiag", nin=1, aliases=["linalg_sumlogdiag"])
def _sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_extractdiag", nin=1, aliases=["linalg_extractdiag"])
def _extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_makediag", nin=1, aliases=["linalg_makediag"])
def _makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset))


def _tri_indices(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("_linalg_extracttrian", nin=1, aliases=["linalg_extracttrian"])
def _extracttrian(A, offset=0, lower=True):
    """The lower (or upper) triangle from diagonal ``offset``, packed row
    by row."""
    r, c = _tri_indices(A.shape[-1], int(offset), attr_truthy(lower),
                        A.device)
    return A[..., r, c]


@register("_linalg_maketrian", nin=1, aliases=["linalg_maketrian"])
def _maketrian(A, offset=0, lower=True):
    """The inverse of ``extracttrian``: the n x n matrix whose packed
    triangle is ``A``."""
    offset, lower = int(offset), attr_truthy(lower)
    m, n = A.shape[-1], 0
    while _tri_indices(n, offset, lower, "cpu").shape[1] < m:
        n += 1
    r, c = _tri_indices(n, offset, lower, A.device)
    out = A.new_zeros(A.shape[:-1] + (n, n))
    out[..., r, c] = A
    return out


@register("_linalg_inverse", nin=1, aliases=["linalg_inverse", "inverse"])
def _inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_det", nin=1, aliases=["linalg_det", "det"])
def _det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", nin=1, nout=2,
          aliases=["linalg_slogdet", "slogdet"])
def _slogdet(A):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("svd", nin=1, nout=3, aliases=["_npi_svd"])
def _svd(A):
    """(U, s, Vᵀ), the reduced factors."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt
