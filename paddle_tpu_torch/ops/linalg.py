"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``; the
``paddle.linalg`` namespace) on ``torch.linalg``. ``lu`` returns 1-based
pivots (LAPACK's), as the JAX package's does."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ._helpers import _op, as_tuple_axis, dims

__all__ = [
    "norm", "vector_norm", "matrix_norm", "dist", "cond", "matrix_rank",
    "cholesky", "qr", "svd", "svdvals", "eig", "eigh", "eigvals", "eigvalsh",
    "inv", "pinv", "solve", "triangular_solve", "cholesky_solve", "lstsq",
    "lu", "det", "slogdet", "matrix_power", "mv", "bmm", "bincount",
    "histogram", "cross", "cov", "corrcoef", "einsum", "multi_dot",
    "householder_product", "matrix_exp", "pca_lowrank",
]


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Frobenius for ``p`` None over all axes or two, else the vector
    ``p``-norm over ``axis``."""
    if p is None:
        p = "fro" if axis is None or (isinstance(axis, (list, tuple))
                                      and len(axis) == 2) else 2.0
    if isinstance(p, str):
        return _op("norm_fro", x, axis=as_tuple_axis(axis),
                   keepdim=bool(keepdim))
    return _op("norm_p", x, p=float(p), axis=as_tuple_axis(axis),
               keepdim=bool(keepdim))


register_op("norm_fro", lambda x, axis=None, keepdim=False: torch.sqrt(
    torch.sum(torch.square(x), dim=dims(axis, x.dim()), keepdim=keepdim)))


def _norm_p(x, p=2.0, axis=None, keepdim=False):
    d = dims(axis, x.dim())
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=d, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=d, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=d, keepdim=keepdim) ** (1.0 / p)


register_op("norm_p", _norm_p)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return _op("norm_p", x, p=float(p), axis=as_tuple_axis(axis),
               keepdim=bool(keepdim))


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    if p == "fro":
        return _op("norm_fro", x, axis=as_tuple_axis(axis),
                   keepdim=bool(keepdim))
    return _op("matrix_norm_ord", x, p=p if isinstance(p, str) else float(p),
               axis=as_tuple_axis(axis), keepdim=bool(keepdim))


register_op("matrix_norm_ord", lambda x, p=2, axis=(-2, -1), keepdim=False:
            torch.linalg.matrix_norm(x, ord=p, dim=axis, keepdim=keepdim))


def dist(x, y, p=2, name=None):
    return _op("dist", x, y, p=float(p))


register_op("dist", lambda x, y, p=2.0: _norm_p(x - y, p=p))


def cond(x, p=None, name=None):
    return _op("cond", x, p=p)


register_op("cond", lambda x, p=None: torch.linalg.cond(x, p))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return _op("matrix_rank", x, tol=tol, hermitian=bool(hermitian))


register_op("matrix_rank", lambda x, tol=None, hermitian=False:
            torch.linalg.matrix_rank(x, atol=tol, hermitian=hermitian))


def cholesky(x, upper=False, name=None):
    return _op("cholesky", x, upper=bool(upper))


register_op("cholesky", lambda x, upper=False:
            torch.linalg.cholesky(x, upper=upper))


def qr(x, mode="reduced", name=None):
    return _op("qr", x, mode=str(mode))


register_op("qr", lambda x, mode="reduced":
            torch.linalg.qr(x, mode="r" if mode == "r" else mode)[1]
            if mode == "r" else tuple(torch.linalg.qr(x, mode=mode)))


def svd(x, full_matrices=False, name=None):
    return _op("svd", x, full_matrices=bool(full_matrices))


register_op("svd", lambda x, full_matrices=False:
            tuple(torch.linalg.svd(x, full_matrices=full_matrices)))


def svdvals(x, name=None):
    return _op("svdvals", x)


register_op("svdvals", torch.linalg.svdvals)


def eig(x, name=None):
    return tuple(_op("eig", x))


register_op("eig", lambda x: tuple(torch.linalg.eig(x)))


def eigvals(x, name=None):
    return _op("eigvals", x)


register_op("eigvals", torch.linalg.eigvals)


def eigh(x, UPLO="L", name=None):
    return tuple(_op("eigh", x, UPLO=str(UPLO)))


register_op("eigh", lambda x, UPLO="L": tuple(torch.linalg.eigh(x, UPLO)))


def eigvalsh(x, UPLO="L", name=None):
    return _op("eigvalsh", x, UPLO=str(UPLO))


register_op("eigvalsh", lambda x, UPLO="L": torch.linalg.eigvalsh(x, UPLO))


def inv(x, name=None):
    return _op("inv", x)


register_op("inv", torch.linalg.inv)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _op("pinv", x, rcond=float(rcond), hermitian=bool(hermitian))


register_op("pinv", lambda x, rcond=1e-15, hermitian=False:
            torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian))


def solve(x, y, name=None):
    return _op("solve", x, y)


register_op("solve", torch.linalg.solve)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _op("triangular_solve", x, y, upper=bool(upper),
               transpose=bool(transpose), unitriangular=bool(unitriangular))


register_op("triangular_solve", lambda x, y, upper=True, transpose=False,
            unitriangular=False: torch.linalg.solve_triangular(
                x.transpose(-1, -2) if transpose else x, y,
                upper=upper != transpose, unitriangular=unitriangular))


def cholesky_solve(x, y, upper=False, name=None):
    return _op("cholesky_solve", x, y, upper=bool(upper))


register_op("cholesky_solve", lambda x, y, upper=False:
            torch.cholesky_solve(x, y, upper))


def lstsq(x, y, rcond=None, driver=None, name=None):
    return tuple(_op("lstsq", x, y, rcond=rcond))


def _lstsq_fwd(x, y, rcond=None):
    sol = torch.linalg.lstsq(x, y, rcond=rcond, driver="gelsd")
    return sol.solution, sol.residuals, sol.rank, sol.singular_values


register_op("lstsq", _lstsq_fwd)


def lu(x, pivot=True, get_infos=False, name=None):
    out = _op("lu", x, pivot=bool(pivot), get_infos=bool(get_infos))
    return tuple(out)


def _lu_fwd(x, pivot=True, get_infos=False):
    lu_mat, piv, info = torch.linalg.lu_factor_ex(x, pivot=pivot)
    return (lu_mat, piv.to(torch.int32), info) if get_infos \
        else (lu_mat, piv.to(torch.int32))


register_op("lu", _lu_fwd)


def det(x, name=None):
    return _op("det", x)


register_op("det", torch.linalg.det)


def slogdet(x, name=None):
    return tuple(_op("slogdet", x))


register_op("slogdet", lambda x: tuple(torch.linalg.slogdet(x)))


def matrix_power(x, n, name=None):
    return _op("matrix_power", x, n=int(n))


register_op("matrix_power", lambda x, n=1: torch.linalg.matrix_power(x, n))


def matrix_exp(x, name=None):
    return _op("matrix_exp", x)


register_op("matrix_exp", torch.linalg.matrix_exp)


def mv(x, vec, name=None):
    return _op("mv", x, vec)


register_op("mv", torch.mv)


def bmm(x, y, name=None):
    return _op("bmm", x, y)


register_op("bmm", torch.bmm)


def bincount(x, weights=None, minlength=0, name=None):
    return _op("bincount", x, weights, minlength=int(minlength))


register_op("bincount", lambda x, w=None, minlength=0:
            torch.bincount(x, w, minlength))


def histogram(input, bins=100, min=0, max=0, name=None):
    return _op("histogram", input, bins=int(bins), min=float(min),
               max=float(max))


def _histogram_fwd(x, bins=100, min=0.0, max=0.0):
    lo, hi = (float(x.min()), float(x.max())) if min == 0 and max == 0 \
        else (min, max)
    return torch.histc(x.float(), bins, lo, hi).to(torch.int64)


register_op("histogram", _histogram_fwd)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (9, Paddle's default: the first
    axis of size 3)."""
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return _op("cross", x, y, axis=int(axis))


register_op("cross", lambda x, y, axis=-1: torch.linalg.cross(x, y, dim=axis))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _op("cov", x, fweights, aweights, rowvar=bool(rowvar),
               ddof=bool(ddof))


register_op("cov", lambda x, fw=None, aw=None, rowvar=True, ddof=True:
            torch.cov(x if rowvar else x.T, correction=int(ddof),
                      fweights=fw, aweights=aw))


def corrcoef(x, rowvar=True, name=None):
    return _op("corrcoef", x, rowvar=bool(rowvar))


register_op("corrcoef", lambda x, rowvar=True:
            torch.corrcoef(x if rowvar else x.T))


def einsum(equation, *operands, name=None):
    ops_ = list(operands)
    if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
        ops_ = list(ops_[0])
    return _op("einsum", ops_, equation=str(equation))


register_op("einsum", lambda xs, equation="": torch.einsum(equation, *xs))


def multi_dot(x, name=None):
    return _op("multi_dot", list(x))


register_op("multi_dot", lambda xs: torch.linalg.multi_dot(list(xs)))


def householder_product(x, tau, name=None):
    return _op("householder_product", x, tau)


register_op("householder_product", torch.linalg.householder_product)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The JAX package's exact form: the top ``q`` singular triplets of the
    centred matrix from a full SVD (no random projection)."""
    a = x
    if q is None:
        q = min(6, a.shape[-2], a.shape[-1])
    return tuple(_op("pca_lowrank", a, q=int(q), center=bool(center)))


def _pca_fwd(a, q=6, center=True):
    if center:
        a = a - a.mean(-2, keepdim=True)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u[..., :q], s[..., :q], vt.transpose(-1, -2)[..., :q]


register_op("pca_lowrank", _pca_fwd)
