"""The port's packed flash attention (paddle_tpu_torch.kernels.flash_pair)
against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version, which is held to the
Pallas kernels in interpret mode (as tests/test_flash_pair.py runs them)
in fp32: the forward's out and lse to ``_pair_fwd``, the backward through
``FlashPairPacked`` to ``jax.vjp`` of ``flash_pair_packed`` in both its
fused and its split form. With dropout the Pallas kernels draw TPU
hardware bits, so the port's dropout is held to its own contract: the
Philox mask of the seed, the written-out backward equal to autograd of the
forward under that mask (fp64), and the plain attention route drawing the
same mask. The CUDA kernels themselves are held to the plain
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
from paddle_tpu_torch.core.random import (get_rng_state, make_generator,
                                          next_seed, seed, set_rng_state)
from paddle_tpu_torch.kernels import f32_fwd_launch_counts, launch_counts, \
    philox, reset_launch_counts
from paddle_tpu_torch.kernels.flash_pair import (FlashPairPacked,
                                                 flash_pair_bwd,
                                                 flash_pair_bwd_reference,
                                                 flash_pair_fwd,
                                                 flash_pair_fwd_reference)
from paddle_tpu_torch.nn import functional as F

NO_LAUNCHES = {"flash_pair_fwd": 0, "flash_pair_bwd": 0,
               "flash_attention_fwd": 0, "flash_attention_bwd": 0,
               "dq_ordered_sum": 0, "dropout_fwd": 0,
               "fused_add_dropout_ln_fwd": 0, "fused_add_dropout_ln_bwd": 0}


def _qkv(b, L, heads, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, L, 3 * heads * d) * 0.5).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [256, 300])
@pytest.mark.parametrize("d", [64, 128, 256])
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


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_384_matches_pallas_interpret(causal):
    """Heads of 384 (above 256: the kernels of csrc/flash_f32_wide.cuh on
    the card in fp32, which the pair gate admits as whole 128-column
    blocks): the
    plain forward against ``_pair_fwd`` and d(qkv) through
    FlashPairPacked against jax.vjp of ``flash_pair_packed``, both in
    interpret mode, at L = 300 (a ragged second tile), fp32 within 1e-4."""
    b, L, heads, d = 1, 300, 2, 384
    x = _qkv(b, L, heads, d, seed=384 + int(causal))
    out_j, lse_j = _pair_fwd(jnp.asarray(x), jnp.asarray([0], jnp.int32),
                             heads, d, causal, 1.0 / math.sqrt(d), 256,
                             dropout_rate=0.0, interpret=True)
    lse_j = np.asarray(lse_j).reshape(b, heads, -1)[:, :, :L]
    xt = torch.from_numpy(x).requires_grad_()
    out_t, lse_t = flash_pair_fwd(xt.detach(), heads, causal)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4, rtol=1e-4)
    g = np.random.RandomState(3).randn(b, L, heads * d).astype(np.float32)
    _, vjp = jax.vjp(lambda a: flash_pair_packed(a, heads, causal,
                                                 interpret=True),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    FlashPairPacked.apply(xt, heads, causal).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


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
        with pytest.raises(ValueError, match="seed"):
            flash_pair_fwd(x, 2, True, dropout_rate=0.1)
        with pytest.raises(ValueError, match="dropout_rate"):
            flash_pair_fwd(x, 2, True, dropout_rate=1.0, seed=1)
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
                                  (2, 300, 4, 64, "bfloat16", False),
                                  (2, 300, 2, 256, "bfloat16", True),
                                  (2, 300, 2, 256, "float32", False),
                                  (2, 512, 2, 384, "bfloat16", True),
                                  (2, 300, 2, 384, "float32", False),
                                  (2, 300, 2, 512, "bfloat16", False)])
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
@pytest.mark.parametrize("d", [64, 128, 256])
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
                                  (2, 300, 4, 64, "bfloat16", False),
                                  (2, 300, 2, 256, "bfloat16", True),
                                  (2, 300, 2, 256, "float32", False),
                                  # the Hopper backward, ragged L
                                  (4, 300, 4, 64, "bfloat16", True),
                                  (2, 333, 4, 128, "bfloat16", False),
                                  # heads above 256
                                  (2, 512, 2, 384, "bfloat16", True),
                                  (2, 300, 2, 384, "float32", False),
                                  (2, 300, 2, 512, "bfloat16", False)])
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
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_bwd=1,
                                   dq_ordered_sum=1)
    hd = heads * d
    # relative Frobenius error per part; the limits of chip_smoke.py's
    # compare-bwd phase (3x its first readings on an H100); fp32 above D =
    # 256 against the exact gradient (the plain versions in fp64 from fp64
    # inputs) within its BIG_D_FP32_REL_LIMIT: there the fp32 plain
    # version itself sits 3e-6 to 4e-6 from it
    limit = 7e-4 if dtype == torch.bfloat16 else 6e-7
    if dtype == torch.float32 and d > 256:
        x64 = x.double()
        o64, l64 = flash_pair_fwd_reference(x64, heads, causal)
        want = flash_pair_bwd_reference(x64, o64, l64, g.double(), heads,
                                        causal)
        limit = 2.3e-6
    else:
        want = flash_pair_bwd_reference(x, out, lse, g, heads, causal)
    for i, part in enumerate(("dq", "dk", "dv")):
        err = _rel(got[..., i * hd:(i + 1) * hd], want[..., i * hd:(i + 1) * hd])
        assert err < limit, f"{part}: relative error {err:.3g} >= {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_fp32_forward_every_head_dim(d, causal, rate):
    """The fp32 forward up to 256 (flash_fwd_f32_small_kernel of
    csrc/flash_f32_wide.cuh) on the pair launcher at each of its head sizes,
    causal and not, at rates 0 and 0.1 and a ragged L = 300, against its
    fp32 plain version (out atol = rtol = 1e-4 on the probability-weighted
    |v|, lse 1e-3), one counted launch of that body; the fp32 backward
    that follows it within [compare-bwd]'s 6e-7 of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, heads = 2, 300, 2
    x, g = _bwd_case(b, L, heads, d, torch.float32, seed=d + 14)
    seed = 0x5EED0 if rate else None
    reset_launch_counts()
    out, lse = flash_pair_fwd(x, heads, causal, rate, seed)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_fwd=1)
    assert f32_fwd_launch_counts() == dict(flash_pair_fwd=1,
                                           flash_attention_fwd=0)
    ref_out, ref_lse = flash_pair_fwd_reference(x, heads, causal, rate, seed)
    absv = x.clone()
    absv[..., 2 * heads * d:] = absv[..., 2 * heads * d:].abs()
    weight = flash_pair_fwd_reference(absv, heads, causal, rate, seed)[0]
    limit = 1e-4 * weight.clamp_min(1.0) + 1e-4 * ref_out.abs()
    assert ((out - ref_out).abs() <= limit).all()
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    got = flash_pair_bwd(x, out, lse, g, heads, causal, rate, seed)
    want = flash_pair_bwd_reference(x, out, lse, g, heads, causal, rate, seed)
    hd = heads * d
    for i, part in enumerate(("dq", "dk", "dv")):
        err = _rel(got[..., i * hd:(i + 1) * hd],
                   want[..., i * hd:(i + 1) * hd])
        assert err < 6e-7, f"{part}: relative error {err:.3g}"


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
                                   flash_pair_bwd=1, dq_ordered_sum=1)
    o2, lse = flash_pair_fwd(x.detach(), 4, True)
    want = flash_pair_bwd_reference(x.detach(), o2, lse, g, 4, True)
    assert _rel(x.grad, want) < 1e-5


# ----------------------------------------------------------------- dropout


@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_dropout_backward_matches_autograd_of_forward_fp64(d, causal):
    """At rate 0.1 the written-out backward (``flash_pair_bwd_reference``:
    p * keep_factor for dV, dp * keep_factor in ds) against torch autograd
    of ``flash_pair_fwd_reference`` under the same mask (the same seed), in
    fp64, where the rounding points are exact."""
    heads, seed, rate = 2, 0xA5A5A5A5A5, 0.1
    x = torch.from_numpy(_qkv(2, 160, heads, d, seed=d)).double() \
        .requires_grad_()
    out, lse = flash_pair_fwd_reference(x, heads, causal, rate, seed)
    g = torch.from_numpy(np.random.RandomState(d + 1).randn(*out.shape))
    out.backward(g)
    got = flash_pair_bwd_reference(x.detach(), out.detach(), lse.detach(), g,
                                   heads, causal, rate, seed)
    torch.testing.assert_close(got, x.grad, atol=1e-10, rtol=1e-10)


def test_dropout_forward_drops_the_philox_pairs():
    """flash_pair_fwd_reference at rate 0.1 is softmax attention whose
    probabilities are multiplied by keep_scale where
    ``philox.attention_keep`` keeps the pair and by 0 where it drops it
    (l over the undropped probabilities); another seed, another output."""
    b, L, heads, d, rate, seed = 2, 96, 2, 64, 0.1, 31337
    x = torch.from_numpy(_qkv(b, L, heads, d, seed=1)).double()
    out, _ = flash_pair_fwd_reference(x, heads, False, rate, seed)
    q, k, v = x.reshape(b, L, 3, heads, d).permute(2, 0, 3, 1, 4)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    keep = philox.attention_keep(seed, b, heads, L, L, rate)
    want = (p * torch.where(keep, 1 / (1 - rate), 0.0)) @ v
    torch.testing.assert_close(out, want.transpose(1, 2).reshape(b, L, -1))
    other, _ = flash_pair_fwd_reference(x, heads, False, rate, seed + 1)
    assert not torch.allclose(other, out)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_route_draws_the_pair_mask(causal):
    """On the CPU, F.flash_attention_qkv_packed in training at dropout 0.1
    runs the plain softmax chain with the pair kernels' mask: its output
    equals the pair plain version at the same seed (drawn from the same
    generator state), and its gradient is the pair backward's."""
    b, L, heads, d = 2, 128, 2, 64
    x = torch.from_numpy(_qkv(b, L, heads, d, seed=11)).requires_grad_()
    gen = torch.Generator()
    gen.manual_seed(4)
    seed = next_seed(gen)
    gen.manual_seed(4)
    out = F.flash_attention_qkv_packed(x, heads, dropout=0.1, causal=causal,
                                       training=True, generator=gen)
    want, lse = flash_pair_fwd_reference(x.detach(), heads, causal, 0.1,
                                         seed)
    torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=1e-5)
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape)
                         .astype(np.float32))
    out.backward(g)
    dx = flash_pair_bwd_reference(x.detach(), want, lse, g, heads, causal,
                                  0.1, seed)
    torch.testing.assert_close(x.grad, dx, atol=1e-5, rtol=1e-5)


def test_packed_attention_dropout_draws_from_the_global_chain():
    """flash_attention_qkv_packed at dropout 0.1 without a generator draws
    its seed from the global chain: after seed(4) it equals the call with
    make_generator(4), and differs from the undropped output; eval draws
    none."""
    x = torch.from_numpy(_qkv(1, 128, 2, 64, seed=13))
    state = get_rng_state()
    seed(4)
    chained = F.flash_attention_qkv_packed(x, 2, dropout=0.1, training=True)
    torch.testing.assert_close(
        chained, F.flash_attention_qkv_packed(x, 2, dropout=0.1,
                                              training=True,
                                              generator=make_generator(4)))
    assert not torch.allclose(chained, F.flash_attention_qkv_packed(
        x, 2, training=True))
    advanced = get_rng_state()
    F.flash_attention_qkv_packed(x, 2, dropout=0.1, training=False)
    assert torch.equal(get_rng_state(), advanced)
    set_rng_state(state)


def test_dropout_seed_is_saved_for_the_backward():
    """FlashPairPacked at rate 0.1 on the CPU: the backward regenerates the
    forward's mask from the saved seed (the gradient equals the backward
    reference at that seed, not another)."""
    x = torch.from_numpy(_qkv(1, 160, 2, 64, seed=12)).requires_grad_()
    out = FlashPairPacked.apply(x, 2, False, 0.1, 99)
    g = torch.ones_like(out)
    out.backward(g)
    o, lse = flash_pair_fwd_reference(x.detach(), 2, False, 0.1, 99)
    want = flash_pair_bwd_reference(x.detach(), o, lse, g, 2, False, 0.1, 99)
    torch.testing.assert_close(x.grad, want)
    other = flash_pair_bwd_reference(x.detach(), o, lse, g, 2, False, 0.1,
                                     98)
    assert not torch.allclose(other, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 512, 12, 64, "bfloat16", False),
                                  (2, 1024, 8, 128, "bfloat16", True),
                                  (2, 300, 4, 64, "float32", True),
                                  (2, 300, 4, 128, "bfloat16", False),
                                  (2, 256, 2, 384, "bfloat16", True),
                                  (2, 300, 2, 512, "bfloat16", False),
                                  # the fp32 wide kernels
                                  (2, 768, 2, 384, "float32", True)])
def test_cuda_dropout_kernels_match_plain(case):
    """The pair kernels at rate 0.1 against their plain versions on the
    same seed (the limits of the rate-0 tests; fp32 above D = 256 the
    backward against the exact gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, heads, d, dt, causal = case
    dtype = getattr(torch, dt)
    x, g = _bwd_case(b, L, heads, d, dtype, seed=13)
    seed = 0x5EED5EED
    reset_launch_counts()
    out, lse = flash_pair_fwd(x, heads, causal, 0.1, seed)
    got = flash_pair_bwd(x, out, lse, g, heads, causal, 0.1, seed)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_fwd=1,
                                   flash_pair_bwd=1, dq_ordered_sum=1)
    ref_out, ref_lse = flash_pair_fwd_reference(x, heads, causal, 0.1, seed)
    atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    # atol scales with the probability-weighted |v| where that exceeds 1
    # (a kept pair carries 1.11 of its p): chip_smoke.py's limit
    absv = x.clone()
    absv[..., 2 * heads * d:] = absv[..., 2 * heads * d:].abs()
    weight = flash_pair_fwd_reference(absv, heads, causal, 0.1, seed)[0]
    limit = atol * weight.float().clamp_min(1.0) + rtol * ref_out.float().abs()
    assert ((out.float() - ref_out.float()).abs() <= limit).all()
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    limit = 7e-4 if dtype == torch.bfloat16 else 6e-7
    if dtype == torch.float32 and d > 256:
        x64 = x.double()
        o64, l64 = flash_pair_fwd_reference(x64, heads, causal, 0.1, seed)
        want = flash_pair_bwd_reference(x64, o64, l64, g.double(), heads,
                                        causal, 0.1, seed)
        limit = 2.3e-6
    else:
        want = flash_pair_bwd_reference(x, out, lse, g, heads, causal, 0.1,
                                        seed)
    hd = heads * d
    for i in range(3):
        assert _rel(got[..., i * hd:(i + 1) * hd],
                    want[..., i * hd:(i + 1) * hd]) < limit
