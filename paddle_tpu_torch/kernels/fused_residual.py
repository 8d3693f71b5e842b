"""The fused residual epilogue ``out = LayerNorm(x + dropout(sub))``.

Counterpart of ``paddle_tpu/kernels/pallas/fused_residual.py``
(``fused_add_dropout_ln``, fused_residual.py:153-172): the transformer
sublayer's residual add, dropout and LayerNorm in one pass over ``[N, H]``
rows, the keep mask drawn in the kernel and regenerated in the backward.
Two kernels, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use and
bound with ``ctypes``:

* ``fused_add_dropout_ln_fwd(x2, s2, weight, bias, seed, rate, eps)``
  (``csrc/fused_residual_fwd.cu``) -> ``(out [N, H]`` in the input type,
  ``stats [2, N]`` fp32: each row's mean and rstd, with ``var = E[h^2] -
  mean^2`` clamped at 0);
* ``fused_add_dropout_ln_bwd(x2, s2, weight, stats, dy, seed, rate, eps)``
  (``csrc/fused_residual_bwd.cu``) -> ``(dx, d(sub), dweight, dbias)``:
  ``h`` recomputed from ``(x, sub, seed)``, dx and d(sub) in the input
  type, and the kernel's per-CTA fp32 dweight/dbias partials summed here in
  fp32 and cast to the weight's type (fused_residual.py:149 sums them in
  XLA).

The keep mask is ``philox.row_keep(seed, SALT_FUSED_LN, N, H, rate)``.
``FusedAddDropoutLN`` puts the pair under autograd. On a CUDA tensor a
wrapper launches its kernel; on a CPU tensor it computes its
``_reference``, the same function in plain torch (the same mask).
Anything the kernels do not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, philox

__all__ = ["fused_add_dropout_ln_fwd", "fused_add_dropout_ln_fwd_reference",
           "fused_add_dropout_ln_bwd", "fused_add_dropout_ln_bwd_reference",
           "FusedAddDropoutLN"]

_DTYPES = (torch.bfloat16, torch.float32)
_ROW_WARPS = 4                     # csrc/fused_residual.cuh kRowWarps
_SMEM_LIMIT = 232448               # bytes of shared memory a CTA may use
_BWD_CTAS = 132 * 4                # the backward's grid: 4 CTAs per SM


def _check(x2, s2, weight, seed, rate, who, plain=False):
    if not 0.0 <= float(rate) < 1.0:
        raise ValueError(f"{who}: rate must be in [0, 1), got {rate}")
    if rate > 0.0:
        philox.check_seed(seed)
    dtypes = _DTYPES + ((torch.float64,) if plain else ())
    if x2.dtype not in dtypes:
        raise TypeError(f"{who}: dtype {x2.dtype} is not supported "
                        f"(bfloat16 or float32)")
    if x2.dim() != 2 or tuple(s2.shape) != tuple(x2.shape):
        raise ValueError(f"{who}: x and sub must be [N, H] of one shape, got "
                         f"{tuple(x2.shape)} and {tuple(s2.shape)}")
    if tuple(weight.shape) != (x2.shape[1],):
        raise ValueError(f"{who}: weight must be [H] = [{x2.shape[1]}], got "
                         f"{tuple(weight.shape)}")
    if s2.dtype != x2.dtype or weight.dtype != x2.dtype:
        raise ValueError(f"{who}: x, sub and weight must share one type, got "
                         f"{x2.dtype}, {s2.dtype}, {weight.dtype}")


def _keep_factor(seed, rate, n, h, device, ct):
    """``[N, H]`` factor of each element: ``keep_scale`` or 0 (None at
    rate 0)."""
    if rate <= 0.0:
        return None
    keep = philox.row_keep(seed, philox.SALT_FUSED_LN, n, h, rate, device)
    return torch.where(keep, philox.keep_scale(rate), 0.0).to(ct)


def _residual(x2, s2, seed, rate, ct):
    """``(h = x + dropout(sub), keep factor or None)`` in ``ct``."""
    f = _keep_factor(seed, rate, *x2.shape, x2.device, ct)
    sf = s2.to(ct)
    if f is not None:
        sf = torch.where(f != 0, sf * f, 0.0)
    return x2.to(ct) + sf, f


def fused_add_dropout_ln_fwd_reference(x2, s2, weight, bias, seed, rate,
                                       eps):
    """The forward kernel's function in plain torch (fp32 math, fp64 for
    fp64 input): ``h = x + where(keep, sub * scale, 0)``, ``mean =
    mean(h)``, ``var = max(mean(h^2) - mean^2, 0)``, ``rstd = rsqrt(var +
    eps)``, ``out = (h - mean) * rstd * w + b``. Returns ``(out, stats [2,
    N])``."""
    _check(x2, s2, weight, seed, rate, "fused_add_dropout_ln_fwd",
           plain=True)
    ct = torch.promote_types(x2.dtype, torch.float32)
    h, _ = _residual(x2, s2, seed, rate, ct)
    mean = h.mean(dim=1)
    var = ((h * h).mean(dim=1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    out = (h - mean[:, None]) * rstd[:, None] * weight.to(ct) + bias.to(ct)
    return out.to(x2.dtype), torch.stack([mean, rstd])


def fused_add_dropout_ln_bwd_reference(x2, s2, weight, stats, dy, seed,
                                       rate, eps):
    """The backward kernel's function in plain torch: ``xhat = (h - mean)
    * rstd`` from the forward's stats, ``dxhat = dy * w``, ``dh = rstd *
    (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))``, ``dx = dh``,
    ``d(sub) = where(keep, dh * scale, 0)`` (input type), ``dweight =
    sum(dy * xhat)``, ``dbias = sum(dy)`` over the rows (fp32, cast to the
    weight's type)."""
    _check(x2, s2, weight, seed, rate, "fused_add_dropout_ln_bwd",
           plain=True)
    ct = torch.promote_types(x2.dtype, torch.float32)
    h, f = _residual(x2, s2, seed, rate, ct)
    mean, rstd = stats[0].to(ct)[:, None], stats[1].to(ct)[:, None]
    xhat = (h - mean) * rstd
    g = dy.to(ct)
    dxhat = g * weight.to(ct)
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dh = rstd * (dxhat - m1 - xhat * m2)
    dsub = dh if f is None else torch.where(f != 0, dh * f, 0.0)
    dw = (g * xhat).sum(dim=0)
    db = g.sum(dim=0)
    return (dh.to(x2.dtype), dsub.to(x2.dtype), dw.to(weight.dtype),
            db.to(weight.dtype))


def _check_card(who, tensors, h):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{who}: every input must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{who}: every input must be 16-byte aligned (the "
                         f"kernel moves 4 elements a vector)")
    if h % 4:
        raise ValueError(f"{who}: H must be a multiple of 4, got {h}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{who}: all inputs must be on one device")


_FWD_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    *philox.KERNEL_ARGTYPES, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + (
    ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    *philox.KERNEL_ARGTYPES, ctypes.c_void_p)


def fused_add_dropout_ln_fwd(x2, s2, weight, bias, seed, rate, eps):
    """``(LayerNorm(x2 + dropout(s2)) [N, H], stats [2, N] fp32)``; ``seed``
    a 64-bit int (unused at rate 0).

    A CUDA tensor launches the kernel on the current stream (counted in
    ``fused_add_dropout_ln_fwd.launches``); a CPU tensor runs
    ``fused_add_dropout_ln_fwd_reference``. Raises on a rate outside [0, 1),
    a type other than bf16/fp32, mixed types or shapes, non-contiguous or
    misaligned input, and an H the kernel's shared memory cannot hold."""
    who = "fused_add_dropout_ln_fwd"
    _check(x2, s2, weight, seed, rate, who)
    if tuple(bias.shape) != tuple(weight.shape) or bias.dtype != x2.dtype:
        raise ValueError(f"{who}: bias must be [H] of the input type")
    if x2.device.type == "cpu":
        return fused_add_dropout_ln_fwd_reference(x2, s2, weight, bias, seed,
                                                  rate, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x2.device}")
    n, h = x2.shape
    _check_card(who, (x2, s2, weight, bias), h)
    if _ROW_WARPS * h * 4 > _SMEM_LIMIT:
        raise ValueError(f"{who}: H = {h} is past the kernel's shared memory")
    out = torch.empty_like(x2)
    stats = torch.empty(2, n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return out, stats
    lib = _build.load(who, _FWD_ARGTYPES)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_add_dropout_ln_fwd(
            x2.data_ptr(), s2.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n, h, float(eps),
            int(x2.dtype == torch.bfloat16), *philox.kernel_args(rate, seed),
            stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {rc})")
    fused_add_dropout_ln_fwd.launches += 1
    return out, stats


fused_add_dropout_ln_fwd.launches = 0


def fused_add_dropout_ln_bwd(x2, s2, weight, stats, dy, seed, rate, eps):
    """``(dx, d(sub), dweight, dbias)`` of ``fused_add_dropout_ln_fwd`` from
    its inputs, its ``stats`` and the output's gradient ``dy``.

    A CUDA tensor launches the kernel on the current stream (counted in
    ``fused_add_dropout_ln_bwd.launches``), then sums its per-CTA fp32
    partials here; a CPU tensor runs ``fused_add_dropout_ln_bwd_reference``.
    Raises as the forward does."""
    who = "fused_add_dropout_ln_bwd"
    _check(x2, s2, weight, seed, rate, who)
    if tuple(dy.shape) != tuple(x2.shape) or dy.dtype != x2.dtype:
        raise ValueError(f"{who}: dy must be [N, H] of the input type")
    n, h = x2.shape
    if tuple(stats.shape) != (2, n) or stats.dtype != torch.float32:
        raise ValueError(f"{who}: stats must be [2, N] float32")
    if x2.device.type == "cpu":
        return fused_add_dropout_ln_bwd_reference(x2, s2, weight, stats, dy,
                                                  seed, rate, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x2.device}")
    _check_card(who, (x2, s2, weight, stats, dy), h)
    if _ROW_WARPS * 4 * h * 4 > _SMEM_LIMIT:
        raise ValueError(f"{who}: H = {h} is past the kernel's shared memory")
    dx = torch.empty_like(x2)
    dsub = torch.empty_like(x2)
    grid = max(1, min(-(-n // _ROW_WARPS), _BWD_CTAS))
    parts = torch.empty(2, grid, h, dtype=torch.float32, device=x2.device)
    if n == 0:
        zero = torch.zeros(h, dtype=weight.dtype, device=x2.device)
        return dx, dsub, zero, zero.clone()
    lib = _build.load(who, _BWD_ARGTYPES)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_add_dropout_ln_bwd(
            x2.data_ptr(), s2.data_ptr(), weight.data_ptr(),
            stats.data_ptr(), dy.data_ptr(), dx.data_ptr(), dsub.data_ptr(),
            parts.data_ptr(), grid, n, h, int(x2.dtype == torch.bfloat16),
            *philox.kernel_args(rate, seed), stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed (cudaError {rc})")
    fused_add_dropout_ln_bwd.launches += 1
    dw, db = parts.sum(dim=1)
    return dx, dsub, dw.to(weight.dtype), db.to(weight.dtype)


fused_add_dropout_ln_bwd.launches = 0


class FusedAddDropoutLN(torch.autograd.Function):
    """``apply(x, sub, weight, bias, seed, rate, eps) -> LayerNorm(x +
    dropout(sub))`` over the last axis of ``x`` and ``sub`` (any leading
    shape). The forward saves ``(x, sub, weight, stats)`` and the seed (an
    int); the backward regenerates the mask from it."""

    @staticmethod
    def forward(ctx, x, sub, weight, bias, seed, rate, eps):
        shape = x.shape
        h = shape[-1]
        x2 = x.reshape(-1, h).contiguous()
        s2 = sub.reshape(-1, h).contiguous()
        out, stats = fused_add_dropout_ln_fwd(x2, s2, weight, bias, seed,
                                              rate, eps)
        ctx.save_for_backward(x2, s2, weight, stats)
        ctx.seed, ctx.rate, ctx.eps, ctx.shape = seed, rate, eps, shape
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, dout):
        x2, s2, weight, stats = ctx.saved_tensors
        dy = dout.reshape(x2.shape).contiguous()
        dx, dsub, dw, db = fused_add_dropout_ln_bwd(
            x2, s2, weight, stats, dy, ctx.seed, ctx.rate, ctx.eps)
        return (dx.reshape(ctx.shape), dsub.reshape(ctx.shape), dw, db,
                None, None, None)
