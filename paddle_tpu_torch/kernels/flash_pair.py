"""Flash attention over the packed qkv layout (the "pair" path).

Counterpart of ``paddle_tpu/kernels/pallas/flash_pair.py``, in-kernel
dropout included. Two kernels, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and bound with ``ctypes``:

* ``flash_pair_fwd(qkv, num_heads, causal, dropout_rate, seed, sm_scale)``
  (``csrc/flash_pair_fwd.cu``) takes the fused projection output ``[B, L,
  3*H*D]`` (columns ``[q heads | k heads | v heads]``) and returns the
  packed context ``[B, L, H*D]`` in the input type and the per-row
  log-sum-exp ``[B, H, L]`` in fp32.
* ``flash_pair_bwd(qkv, out, lse, dout, num_heads, causal, dropout_rate,
  seed, sm_scale)`` (``csrc/flash_pair_bwd.cu``) returns ``d(qkv)`` ``[B, L,
  3*H*D]`` in the packed layout: the one-pass backward of ``_pair_bwd``,
  fused and split forms alike (they compute the same function).

At ``dropout_rate > 0`` both drop the attention probabilities under the
keep mask of ``philox.attention_keep(seed, ...)``, keyed on (b, h, q
position, key position): the backward regenerates the forward's mask from
the same seed, and the plain versions draw the same one.

``FlashPairPacked`` ties them together under autograd. On a CUDA tensor a
wrapper launches its kernel; on a CPU tensor it computes its ``_reference``,
the same math in plain torch. There is no other path: anything the kernels
do not take raises.

While the monitor counts a call's FLOPs (``monitor.goodput.FlopCount``)
each wrapper reports its score and context products, which the counter
cannot see through ``ctypes``; on the CPU it runs the plain version
outside the count and reports the same number (``_report``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..monitor import goodput as _goodput
from . import _build, philox

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference", "flash_pair_bwd",
           "flash_pair_bwd_reference", "FlashPairPacked",
           "pair_layout_supported", "fwd_work_floats", "bwd_work_floats"]

_NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128, 256)   # csrc/flash_attention.cuh PairHeadDims
# above 256 the pair gate's whole 128-column blocks run the wide kernels of
# csrc/flash_wide_sm90.cuh (bf16) and csrc/flash_f32_wide.cuh (fp32)
# the bf16 backward at this head size and above runs the wide body, which
# reads a scaled copy of q from its workspace (csrc/flash_wide_sm90.cuh
# ``bwd_takes``)
_WIDE_BWD_MIN_D = 256


def _kernel_takes(d: int) -> bool:
    """Whether the pair kernels are built for head size ``d``."""
    return d in _HEAD_DIMS or (d > _HEAD_DIMS[-1] and d % 128 == 0)


def fwd_work_floats(b: int, lq: int, h: int, d: int, dtype) -> int:
    """Floats of a forward launch's fp32 workspace: the bf16 wide
    kernel's copy of ``round(q * scale)`` above ``D = 256``, bf16 ``[B, Lq,
    H*D]`` (half a float an element); none otherwise (the fp32 kernels keep
    their accumulators in shared memory)."""
    if dtype != torch.bfloat16 or d <= _HEAD_DIMS[-1]:
        return 0
    return b * lq * h * d // 2


def bwd_work_floats(b: int, lq: int, h: int, d: int, dtype) -> int:
    """Floats of a backward launch's fp32 workspace
    (csrc/flash_attention.cuh ``bwd_work_floats``): dq's scratch ``[B, Lq,
    H*D]``, lse and delta at rows padded to a multiple of 64 ``[B*H,
    Lq_pad]`` each, and in bf16 at ``D >= 256`` the wide body's copy of
    ``round(q * scale)``, bf16 ``[B, Lq, H*D]``."""
    lq_pad = -(-lq // 64) * 64
    n = b * lq * h * d + 2 * b * h * lq_pad
    if dtype == torch.bfloat16 and d >= _WIDE_BWD_MIN_D:
        n += b * lq * h * d // 2
    return n


# the bf16 backward's head sizes on 32-byte swizzle blocks
# (csrc/flash_bwd_sm90.cuh)
_SW32_BWD_DIMS = (80, 96)


def count_bodies(wrapper, dtype, d: int, backward: bool = False):
    """Count one launch by ``wrapper`` at head size ``d`` in the counter of
    the body that runs it, where that body has one: bf16 above 256 (the
    backward from 256) in ``.wide_launches`` (csrc/flash_wide_sm90.cuh),
    fp32 above 256 in ``.f32_wide_launches`` (csrc/flash_f32_wide.cuh's
    wide kernels); fp32 up to 256 in ``.f32_fwd_launches`` (the forward,
    ``flash_fwd_f32_small_kernel``) or ``.f32_bwd_launches`` (the backward,
    ``flash_bwd_f32_kernel``), the bf16 backward at 80 and 96 in
    ``.sw32_bwd_launches`` (csrc/flash_bwd_sm90.cuh on 32-byte swizzle
    blocks)."""
    if dtype == torch.bfloat16:
        if d > _HEAD_DIMS[-1] or (backward and d >= _WIDE_BWD_MIN_D):
            wrapper.wide_launches += 1
        elif backward and d in _SW32_BWD_DIMS:
            wrapper.sw32_bwd_launches += 1
    elif d > _HEAD_DIMS[-1]:
        wrapper.f32_wide_launches += 1
    elif backward:
        wrapper.f32_bwd_launches += 1
    else:
        wrapper.f32_fwd_launches += 1


def _report(b: int, L: int, h: int, d: int, causal: bool,
            backward: bool = False):
    """Into the open FLOP count: one launch's attention products."""
    pairs = L * (L + 1) // 2 if causal else L * L
    _goodput.kernel_flops(_goodput.attention_flops(b, h, pairs, d,
                                                   backward))


def _heads_per_block(head_dim: int) -> int:
    """How many adjacent heads fill a 128-wide column block (2 at d=64, 1
    at d=128)."""
    return max(1, 128 // head_dim)


def pair_layout_supported(head_dim: int, num_heads: int,
                          seq_len: int = 0) -> bool:
    """The pair path's shape gate, as in the JAX package: whole head
    blocks fill the 128-wide column quantum. Any sequence length."""
    hpb = _heads_per_block(head_dim)
    return ((hpb * head_dim) % 128 == 0 and head_dim % 8 == 0
            and num_heads % hpb == 0)


def _scale(d: int, sm_scale) -> float:
    """The softmax scale: ``sm_scale``, or ``1 / sqrt(D)`` when None."""
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _compute_type(dt: torch.dtype) -> torch.dtype:
    """fp32 for the kernels' types; fp64 stays fp64 (the plain versions
    take it for gradient checks)."""
    return torch.promote_types(dt, torch.float32)


def _check(qkv: torch.Tensor, num_heads: int, dropout_rate: float,
           seed=None, who: str = "flash_pair_fwd", plain: bool = False) -> int:
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError(f"{who}: dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError(f"{who}: dropout_rate > 0 needs a seed "
                         f"(core.random.next_seed)")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{who}: qkv must be [B, L, 3*H*D] with "
                         f"H={num_heads}, got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * num_heads)
    if not _kernel_takes(d) or not pair_layout_supported(d, num_heads):
        raise ValueError(f"{who}: head_dim {d} with {num_heads} "
                         f"heads is not supported (head_dim in {_HEAD_DIMS} "
                         f"or a multiple of 128 above 256, num_heads a "
                         f"multiple of max(1, 128 // head_dim))")
    if qkv.dtype not in _DTYPES + ((torch.float64,) if plain else ()):
        raise TypeError(f"{who}: dtype {qkv.dtype} is not "
                        f"supported (bfloat16 or float32)")
    if not qkv.is_contiguous():
        raise ValueError(f"{who}: qkv must be contiguous")
    return d


def _keep_factor(qkv, num_heads, dropout_rate, seed, ct):
    """``[B, H, L, L]`` factor of each attended pair: ``keep_scale`` where
    the Philox word keeps it, 0 where it drops (None at rate 0)."""
    if dropout_rate <= 0.0:
        return None
    b, L, _ = qkv.shape
    keep = philox.attention_keep(seed, b, num_heads, L, L, dropout_rate,
                                 qkv.device)
    return torch.where(keep, philox.keep_scale(dropout_rate), 0.0).to(ct)


def flash_pair_fwd_reference(qkv: torch.Tensor, num_heads: int,
                             causal: bool, dropout_rate: float = 0.0,
                             seed=None, sm_scale=None):
    """The kernel's math in fp32 torch: q * scale (``sm_scale``, default
    ``1 / sqrt(D)``) rounded to the input
    type before Q.K^T, the mask at -1e30, ``l`` summed over the undropped
    probabilities, then each probability times its keep factor (dropout),
    rounded to v's type before P.V, and the final ``acc / max(l, 1e-30)``.
    Returns ``(out [B, L, H*D] in qkv's type, lse [B, H, L] fp32)``. Takes
    fp64 too (computed in fp64), for gradient checks."""
    d = _check(qkv, num_heads, dropout_rate, seed, plain=True)
    b, L, _ = qkv.shape
    dt = qkv.dtype
    ct = _compute_type(dt)
    x = qkv.reshape(b, L, 3, num_heads, d).permute(0, 2, 3, 1, 4)  # [b,3,H,L,d]
    q = (x[:, 0].to(ct) * _scale(d, sm_scale)).to(dt).to(ct)
    k = x[:, 1].to(ct)
    v = x[:, 2].to(ct)
    s = q @ k.transpose(-1, -2)                               # [b,H,L,L]
    if causal:
        valid = torch.ones(L, L, dtype=torch.bool,
                           device=qkv.device).tril()
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    f = _keep_factor(qkv, num_heads, dropout_rate, seed, ct)
    if f is not None:
        p = p * f
    o = (p.to(dt).to(ct) @ v) / l
    lse = (m + torch.log(l))[..., 0]
    out = o.transpose(1, 2).reshape(b, L, num_heads * d).to(dt)
    return out, lse


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             *philox.KERNEL_ARGTYPES, ctypes.c_void_p)


def flash_pair_fwd(qkv: torch.Tensor, num_heads: int, causal: bool,
                   dropout_rate: float = 0.0, seed=None, sm_scale=None):
    """Packed flash-attention forward: ``(out [B, L, H*D], lse [B, H, L])``,
    the probabilities dropped at ``dropout_rate`` under ``seed`` (a 64-bit
    int; required when the rate is positive); the scores scaled by
    ``sm_scale`` (default ``1 / sqrt(D)``).

    A CUDA tensor launches the kernel on the current stream (one launch
    per call, counted in ``flash_pair_fwd.launches``; a head above 256 also
    in ``.wide_launches``, the bf16 wide kernel's, or ``.f32_wide_launches``,
    the fp32 one's, and an fp32 head up to 256 in ``.f32_fwd_launches``); a
    CPU tensor runs ``flash_pair_fwd_reference``. Raises
    on a rate outside [0, 1), a positive rate without a seed, a head size
    other than 64, 128, 256 or a multiple of 128 above 256 (there the bf16
    kernel takes an fp32 workspace of ``fwd_work_floats``), a type other
    than bf16/fp32 and non-contiguous input."""
    d = _check(qkv, num_heads, dropout_rate, seed)
    if qkv.device.type == "cpu":
        if not _goodput.counting():
            return flash_pair_fwd_reference(qkv, num_heads, causal,
                                            dropout_rate, seed, sm_scale)
        with _goodput.uncounted():
            res = flash_pair_fwd_reference(qkv, num_heads, causal,
                                           dropout_rate, seed, sm_scale)
        _report(qkv.shape[0], qkv.shape[1], num_heads, d, causal)
        return res
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_pair_fwd: unsupported device {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("flash_pair_fwd: qkv must be 16-byte aligned (the "
                         "kernels read it with TMA and in 16-byte vectors)")
    b, L, _ = qkv.shape
    out = torch.empty(b, L, num_heads * d, dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty(b, num_heads, L, dtype=torch.float32,
                      device=qkv.device)
    n_work = fwd_work_floats(b, L, num_heads, d, qkv.dtype)
    work = torch.empty(n_work, dtype=torch.float32, device=qkv.device) \
        if n_work else None
    lib = _build.load("flash_pair_fwd", _ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_pair_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
            None if work is None else work.data_ptr(), b, L, num_heads, d,
            int(qkv.dtype == torch.bfloat16), int(bool(causal)),
            _scale(d, sm_scale), *philox.kernel_args(dropout_rate, seed),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_pair_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_pair_fwd.launches += 1
    count_bodies(flash_pair_fwd, qkv.dtype, d)
    if _goodput.counting():
        _report(b, L, num_heads, d, causal)
    return out, lse


flash_pair_fwd.launches = 0
flash_pair_fwd.wide_launches = 0
flash_pair_fwd.f32_wide_launches = 0
flash_pair_fwd.f32_fwd_launches = 0


def _check_bwd(qkv, out, lse, dout, num_heads, dropout_rate, seed,
               plain=False):
    d = _check(qkv, num_heads, dropout_rate, seed, who="flash_pair_bwd",
               plain=plain)
    b, L, _ = qkv.shape
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (b, L, num_heads * d) or t.dtype != qkv.dtype:
            raise ValueError(f"flash_pair_bwd: {name} must be [B, L, H*D] = "
                             f"{(b, L, num_heads * d)} of {qkv.dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
    if tuple(lse.shape) != (b, num_heads, L) or lse.dtype != \
            _compute_type(qkv.dtype):
        raise ValueError(f"flash_pair_bwd: lse must be [B, H, L] = "
                         f"{(b, num_heads, L)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_pair_bwd: out, lse and dout must be "
                         "contiguous")
    if len({t.device for t in (qkv, out, lse, dout)}) != 1:
        raise ValueError("flash_pair_bwd: all inputs must be on one device")
    return d


def _delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int):
    """``rowsum(dO * O)`` in fp32 (fp64 for fp64 input) as ``[B, H, L]``
    (flash_pair.py:451-455, outside the kernel there too)."""
    b, L, hd = out.shape
    ct = _compute_type(out.dtype)
    prod = dout.to(ct) * out.to(ct)
    return prod.reshape(b, L, num_heads, hd // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


def flash_pair_bwd_reference(qkv: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             num_heads: int, causal: bool,
                             dropout_rate: float = 0.0, seed=None,
                             sm_scale=None):
    """The backward kernel's math in fp32 torch, written out as the Pallas
    ``_bwd_tile_core`` has it (not autograd of the forward): ``qs = q *
    scale`` rounded to the input type, ``p = exp(qs.K^T - lse)`` zeroed
    where masked, ``f`` the forward's keep factor of each pair (1 at rate
    0), ``dp = (dO.V^T) * f``, ``ds = p * (dp - delta)`` rounded to the
    input type, ``dq = ds.K * scale``, ``dk = ds^T.q * scale`` with the
    unscaled q, ``dv = round(p * f)^T.dO``. Returns ``d(qkv)`` ``[B, L,
    3*H*D]`` in qkv's type. Takes fp64 too (computed in fp64)."""
    d = _check_bwd(qkv, out, lse, dout, num_heads, dropout_rate, seed,
                   plain=True)
    b, L, _ = qkv.shape
    dt = qkv.dtype
    ct = _compute_type(dt)
    scale = _scale(d, sm_scale)
    x = qkv.reshape(b, L, 3, num_heads, d).permute(0, 2, 3, 1, 4)  # [b,3,H,L,d]
    q = x[:, 0].to(ct)
    k = x[:, 1].to(ct)
    v = x[:, 2].to(ct)
    qs = (q * scale).to(dt).to(ct)
    s = qs @ k.transpose(-1, -2)                              # [b,H,L,L]
    p = torch.exp(s - lse[..., None])
    if causal:
        valid = torch.ones(L, L, dtype=torch.bool,
                           device=qkv.device).tril()
        p = torch.where(valid, p, 0.0)
    do = dout.reshape(b, L, num_heads, d).transpose(1, 2).to(ct)
    dp = do @ v.transpose(-1, -2)
    p_dv = p
    f = _keep_factor(qkv, num_heads, dropout_rate, seed, ct)
    if f is not None:
        p_dv = p * f
        dp = dp * f
    ds = (p * (dp - _delta(out, dout, num_heads)[..., None])).to(dt).to(ct)
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p_dv.to(dt).to(ct).transpose(-1, -2) @ do
    dqkv = torch.stack([dq, dk, dv], dim=1)                   # [b,3,H,L,d]
    return dqkv.permute(0, 3, 1, 2, 4).reshape(b, L, 3 * num_heads * d) \
        .to(dt)


_BWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 *philox.KERNEL_ARGTYPES, ctypes.c_void_p)


def flash_pair_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                   dout: torch.Tensor, num_heads: int, causal: bool,
                   dropout_rate: float = 0.0, seed=None, sm_scale=None):
    """Packed flash-attention backward: ``d(qkv)`` ``[B, L, 3*H*D]`` in
    qkv's type from the forward's inputs and outputs and the output's
    gradient ``dout``; ``dropout_rate``, ``seed`` and ``sm_scale`` are the
    forward's.

    A CUDA tensor launches the kernel on the current stream (one counted
    launch per call in ``flash_pair_bwd.launches``; a bf16 head of 256 or
    more, the wide body's, also in ``.wide_launches``, an fp32 head above
    256, the fp32 wide body's, in ``.f32_wide_launches``, an fp32 head up
    to 256 in ``.f32_bwd_launches``; a pre-pass launch
    before the kernel computes ``delta = rowsum(dO*O)``, as the JAX package
    computes it outside its kernel, and zeroes dq's fp32 scratch, and a
    small conversion launch behind it writes dq; all in one fp32
    workspace); a CPU tensor runs ``flash_pair_bwd_reference``. Raises on
    what the kernel does not take: a head size other than 64, 128, 256 or a
    multiple of 128 above 256, a type other than bf16/fp32, mismatched
    shapes or types, non-contiguous or misaligned input."""
    d = _check_bwd(qkv, out, lse, dout, num_heads, dropout_rate, seed)
    if qkv.device.type == "cpu":
        if not _goodput.counting():
            return flash_pair_bwd_reference(qkv, out, lse, dout, num_heads,
                                            causal, dropout_rate, seed,
                                            sm_scale)
        with _goodput.uncounted():
            res = flash_pair_bwd_reference(qkv, out, lse, dout, num_heads,
                                           causal, dropout_rate, seed,
                                           sm_scale)
        _report(qkv.shape[0], qkv.shape[1], num_heads, d, causal, True)
        return res
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_pair_bwd: unsupported device {qkv.device}")
    if qkv.data_ptr() % 16 or out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("flash_pair_bwd: qkv, out and dout must be 16-byte "
                         "aligned (the kernels read them with TMA and in "
                         "16-byte vectors)")
    b, L, _ = qkv.shape
    work = torch.empty(bwd_work_floats(b, L, num_heads, d, qkv.dtype),
                       dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    lib = _build.load("flash_pair_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_pair_bwd(
            qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            work.data_ptr(), dqkv.data_ptr(), b, L,
            num_heads, d, int(qkv.dtype == torch.bfloat16), int(bool(causal)),
            _scale(d, sm_scale), *philox.kernel_args(dropout_rate, seed),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_pair_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_pair_bwd.launches += 1
    count_bodies(flash_pair_bwd, qkv.dtype, d, backward=True)
    if _goodput.counting():
        _report(b, L, num_heads, d, causal, True)
    return dqkv


flash_pair_bwd.launches = 0
flash_pair_bwd.wide_launches = 0
flash_pair_bwd.f32_wide_launches = 0
flash_pair_bwd.f32_bwd_launches = 0
flash_pair_bwd.sw32_bwd_launches = 0


class FlashPairPacked(torch.autograd.Function):
    """Packed flash attention under autograd (the counterpart of the JAX
    package's ``custom_vjp`` ``flash_pair``): ``forward`` runs
    ``flash_pair_fwd`` and saves ``(qkv, out, lse)`` and the dropout seed
    (an int), ``backward`` runs ``flash_pair_bwd``, which regenerates the
    forward's mask from that seed, and returns ``d(qkv)``. ``apply(qkv,
    num_heads, causal, dropout_rate=0.0, seed=None, sm_scale=None) -> out
    [B, L, H*D]``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, dropout_rate=0.0, seed=None,
                sm_scale=None):
        out, lse = flash_pair_fwd(qkv, num_heads, causal, dropout_rate, seed,
                                  sm_scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        ctx.causal = causal
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = flash_pair_bwd(qkv, out, lse, dout.contiguous(),
                              ctx.num_heads, ctx.causal, ctx.dropout_rate,
                              ctx.seed, ctx.sm_scale)
        return dqkv, None, None, None, None, None
