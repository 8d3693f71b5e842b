"""The port's packed flash attention (paddle_tpu_torch.kernels.flash_pair)
against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version, which is held to the
Pallas kernels in interpret mode (as tests/test_flash_pair.py runs them)
in fp32: the forward's out and lse to ``_pair_fwd``, the backward through
``FlashPairPacked`` to ``jax.vjp`` of ``flash_pair_packed`` in both its
fused and its split form. The CUDA kernels themselves are held to the plain
versions by the ``cuda``-marked tests, which run only where a card is
present.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_pair import _pair_fwd, flash_pair_packed
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.flash_pair import (FlashPairPacked,
                                                 flash_pair_bwd,
                                                 flash_pair_bwd_reference,
                                                 flash_pair_fwd,
                                                 flash_pair_fwd_reference)

NO_LAUNCHES = {"flash_pair_fwd": 0, "flash_pair_bwd": 0,
               "flash_attention_fwd": 0, "flash_attention_bwd": 0}


def _qkv(b, L, heads, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, L, 3 * heads * d) * 0.5).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [256, 300])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_pallas_interpret(d, L, causal):
    b, heads = 2, 2
    x = _qkv(b, L, heads, d, seed=d + L)
    out_j, lse_j = _pair_fwd(jnp.asarray(x), jnp.asarray([0], jnp.int32),
                             heads, d, causal, 1.0 / math.sqrt(d), 256,
                             dropout_rate=0.0, interpret=True)
    # Pallas lse is [B, H/hpb, hpb, Lpad] -> [B, H, L]
    lse_j = np.asarray(lse_j).reshape(b, heads, -1)[:, :, :L]
    out_t, lse_t = flash_pair_fwd_reference(torch.from_numpy(x), heads,
                                            causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4, rtol=1e-4)


def test_cpu_tensor_takes_plain_path_uncounted():
    x = torch.from_numpy(_qkv(1, 160, 2, 64, seed=3))
    reset_launch_counts()
    out, lse = flash_pair_fwd(x, 2, True)
    ref_out, ref_lse = flash_pair_fwd_reference(x, 2, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert out.shape == (1, 160, 128) and lse.shape == (1, 2, 160)
    assert launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("bad", ["dropout", "head_dim", "dtype", "layout",
                                 "odd_heads"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 128, 3 * 2 * 64)
    if bad == "dropout":
        with pytest.raises(NotImplementedError):
            flash_pair_fwd(x, 2, True, dropout_rate=0.1)
    elif bad == "head_dim":
        with pytest.raises(ValueError):
            flash_pair_fwd(torch.zeros(1, 128, 3 * 4 * 32), 4, True)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_pair_fwd(x.half(), 2, True)
    elif bad == "layout":
        with pytest.raises(ValueError):
            flash_pair_fwd(torch.zeros(1, 3 * 2 * 64, 128).transpose(1, 2),
                           2, True)
    else:
        with pytest.raises(ValueError):
            flash_pair_fwd(torch.zeros(1, 128, 3 * 3 * 64), 3, True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 1024, 8, 128, "bfloat16", True),
                                  (2, 300, 4, 64, "float32", True),
                                  (2, 300, 4, 64, "bfloat16", False)])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, heads, d, dt, causal = case
    dtype = getattr(torch, dt)
    # q, k ~ N(0, 2^2) and v ~ N(0, 1): peaked softmax rows and O(1)
    # outputs, so a lost kv tile or a misread v row is far off the limit
    # (the same inputs and limits as chip_smoke.py's compare phase)
    rs = np.random.RandomState(7)
    x = rs.randn(b, L, 3, heads * d) * np.array([2.0, 2.0, 1.0])[:, None]
    x = torch.from_numpy(x.reshape(b, L, -1).astype(np.float32))
    x = x.cuda().to(dtype)
    reset_launch_counts()
    out, lse = flash_pair_fwd(x, heads, causal)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_fwd=1)
    ref_out, ref_lse = flash_pair_fwd_reference(x, heads, causal)
    atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------- backward


@pytest.mark.parametrize("max_fused_bwd", [None, 0], ids=["fused", "split"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [256, 300])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_matches_pallas_vjp(d, L, causal, max_fused_bwd):
    """d(qkv) through FlashPairPacked on the CPU against jax.vjp of the
    Pallas pair path in interpret mode, on the same random cotangent; the
    fused form (one kernel) and the split form (dq + dkv kernels,
    ``max_fused_bwd=0``) compute one function."""
    b, heads = 1, 2
    x = _qkv(b, L, heads, d, seed=d + L + int(causal))
    g = np.random.RandomState(L).randn(b, L, heads * d).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda a: flash_pair_packed(a, heads, causal, interpret=True,
                                    max_fused_bwd=max_fused_bwd),
        jnp.asarray(x))
    dqkv_j, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = FlashPairPacked.apply(xt, heads, causal)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dqkv_j),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_reference_matches_autograd_of_forward(d, causal):
    """The written-out backward formula against torch autograd of the plain
    forward (fp32: the rounding points are exact there)."""
    x = torch.from_numpy(_qkv(2, 200, 2, d, seed=5)).requires_grad_()
    out, lse = flash_pair_fwd_reference(x, 2, causal)
    g = torch.from_numpy(
        np.random.RandomState(6).randn(*out.shape).astype(np.float32))
    out.backward(g)
    got = flash_pair_bwd_reference(x.detach(), out.detach(), lse.detach(), g,
                                   2, causal)
    torch.testing.assert_close(got, x.grad, atol=1e-5, rtol=1e-5)


def test_gradient_flows_through_the_function_uncounted():
    """qkv.grad arrives through FlashPairPacked (the packed path is not a
    detached tensor), and CPU tensors never count a launch."""
    x = torch.from_numpy(_qkv(1, 160, 2, 64, seed=8)).requires_grad_()
    reset_launch_counts()
    out = FlashPairPacked.apply(x, 2, True)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert torch.count_nonzero(x.grad[..., :128]) > 0     # dq reached qkv
    assert launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "out_shape", "lse_type",
                                 "mixed_type", "layout"])
def test_backward_refuses_what_the_kernel_does_not_take(bad):
    b, L, heads, d = 1, 128, 2, 64
    qkv = torch.zeros(b, L, 3 * heads * d)
    out = torch.zeros(b, L, heads * d)
    lse = torch.zeros(b, heads, L)
    dout = torch.zeros(b, L, heads * d)
    if bad == "head_dim":
        with pytest.raises(ValueError):
            flash_pair_bwd(torch.zeros(b, L, 3 * 4 * 32), out, lse, dout, 4,
                           True)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_pair_bwd(qkv.half(), out.half(), lse, dout.half(), heads,
                           True)
    elif bad == "out_shape":
        with pytest.raises(ValueError):
            flash_pair_bwd(qkv, out[:, :64], lse, dout, heads, True)
    elif bad == "lse_type":
        with pytest.raises(ValueError):
            flash_pair_bwd(qkv, out, lse.double(), dout, heads, True)
    elif bad == "mixed_type":
        with pytest.raises(ValueError):
            flash_pair_bwd(qkv, out, lse, dout.bfloat16(), heads, True)
    else:
        with pytest.raises(ValueError):
            flash_pair_bwd(qkv, out, lse,
                           torch.zeros(b, heads * d, L).transpose(1, 2),
                           heads, True)


def _bwd_case(b, L, heads, d, dtype, seed):
    """q, k ~ N(0, 2^2), v and dO ~ N(0, 1) on the card (the inputs of
    chip_smoke.py's compare-bwd phase)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, L, 3, heads * d) * np.array([2.0, 2.0, 1.0])[:, None]
    x = torch.from_numpy(x.reshape(b, L, -1).astype(np.float32))
    g = torch.from_numpy(rs.randn(b, L, heads * d).astype(np.float32))
    return x.cuda().to(dtype), g.cuda().to(dtype)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 1024, 8, 128, "bfloat16", True),
                                  (2, 300, 4, 64, "float32", True),
                                  (2, 300, 4, 64, "bfloat16", False)])
def test_cuda_backward_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, heads, d, dt, causal = case
    dtype = getattr(torch, dt)
    x, g = _bwd_case(b, L, heads, d, dtype, seed=9)
    out, lse = flash_pair_fwd(x, heads, causal)
    reset_launch_counts()
    got = flash_pair_bwd(x, out, lse, g, heads, causal)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_bwd=1)
    want = flash_pair_bwd_reference(x, out, lse, g, heads, causal)
    hd = heads * d
    # relative Frobenius error per part; the limits of chip_smoke.py's
    # compare-bwd phase (3x its first readings on an H100)
    limit = 7e-4 if dtype == torch.bfloat16 else 6e-7
    for i, part in enumerate(("dq", "dk", "dv")):
        err = _rel(got[..., i * hd:(i + 1) * hd], want[..., i * hd:(i + 1) * hd])
        assert err < limit, f"{part}: relative error {err:.3g} >= {limit}"


@pytest.mark.cuda
def test_cuda_gradient_flows_through_the_function():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, g = _bwd_case(2, 256, 4, 64, torch.float32, seed=10)
    x.requires_grad_()
    reset_launch_counts()
    out = FlashPairPacked.apply(x, 4, True)
    out.backward(g)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_fwd=1,
                                   flash_pair_bwd=1)
    o2, lse = flash_pair_fwd(x.detach(), 4, True)
    want = flash_pair_bwd_reference(x.detach(), o2, lse, g, 4, True)
    assert _rel(x.grad, want) < 1e-5
