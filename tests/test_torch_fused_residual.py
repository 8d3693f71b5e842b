"""The port's fused residual epilogue LayerNorm(x + dropout(sub))
(paddle_tpu_torch.kernels.fused_residual) against the JAX package's Pallas
kernels.

On the CPU each wrapper runs its plain version. At rate 0 it is held to
the Pallas ``_fused_fwd`` / ``_fused_bwd`` in interpret mode (as
tests/test_fused_residual.py runs them): fp32 within 1e-5, bf16 within one
bf16 ulp. At rate 0.1 the Pallas kernels draw the TPU's hardware bits,
which no CPU run has, so the port is held to itself: the forward and the
backward drop the same elements (the Philox mask of the seed), and the
written-out backward equals autograd of the plain forward under that mask
in fp64. The CUDA kernels are held to the plain versions by the
``cuda``-marked tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.fused_residual import _fused_bwd, _fused_fwd
from paddle_tpu_torch.core.random import get_rng_state, seed, set_rng_state
from paddle_tpu_torch.kernels import launch_counts, philox, \
    reset_launch_counts
from paddle_tpu_torch.kernels.fused_residual import (
    FusedAddDropoutLN, fused_add_dropout_ln_bwd,
    fused_add_dropout_ln_bwd_reference, fused_add_dropout_ln_fwd,
    fused_add_dropout_ln_fwd_reference)
from paddle_tpu_torch.nn import functional as F

EPS = 1e-12
NO_LAUNCHES = {"flash_pair_fwd": 0, "flash_pair_bwd": 0,
               "flash_attention_fwd": 0, "flash_attention_bwd": 0,
               "dq_ordered_sum": 0, "dropout_fwd": 0,
               "fused_add_dropout_ln_fwd": 0, "fused_add_dropout_ln_bwd": 0}


def _inputs(n, h, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h).astype(np.float32)
    s = rs.randn(n, h).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(h)).astype(np.float32)
    b = (0.1 * rs.randn(h)).astype(np.float32)
    g = rs.randn(n, h).astype(np.float32)
    return x, s, w, b, g


def _ulp_bf16(a):
    """One bf16 ulp of |a| (float32 array)."""
    a = np.abs(a)
    e = np.floor(np.log2(np.maximum(a, 1e-30)))
    return np.where(a > 0, np.exp2(e - 7), 0.0)


def _to(a, dtype):
    """numpy fp32 -> (torch tensor in dtype, jax array in dtype)."""
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                              else jnp.float32)
    return t, j


def _f32(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 128), (64, 768)])
def test_rate0_matches_pallas_interpret(shape, dtype):
    """out, the (mean, rstd) stats, dx, d(sub), dw, db of the plain
    version against the Pallas kernels in interpret mode at rate 0: fp32
    within 1e-5; bf16 within one bf16 ulp of the reference (+1e-5), the
    two summing rows in other orders."""
    dt = getattr(torch, dtype)
    x, s, w, b, g = _inputs(*shape, seed=shape[0] + shape[1])
    (xt, xj), (st, sj), (wt, wj), (bt, bj), (gt, gj) = (
        _to(a, dt) for a in (x, s, w, b, g))
    seed = jnp.zeros((1,), jnp.int32)
    out_j, stats_j = _fused_fwd(xj, sj, wj, bj, seed, 0.0, EPS,
                                interpret=True)
    dx_j, ds_j, dw_j, db_j = _fused_bwd(xj, sj, wj, stats_j, gj, seed, 0.0,
                                        EPS, interpret=True)
    out_t, stats_t = fused_add_dropout_ln_fwd(xt, st, wt, bt, 0, 0.0, EPS)
    dx_t, ds_t, dw_t, db_t = fused_add_dropout_ln_bwd(xt, st, wt, stats_t,
                                                      gt, 0, 0.0, EPS)
    np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j),
                               rtol=1e-5, atol=1e-6)
    pairs = [("out", out_t, out_j), ("dx", dx_t, dx_j), ("ds", ds_t, ds_j),
             ("dw", dw_t, dw_j), ("db", db_t, db_j)]
    for name, got, want in pairs:
        got, want = _f32(got), _f32(want)
        if dt == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            # dw, db: the JAX sums stay fp32; the port casts them to the
            # weight's type, so its value is the reference rounded
            want_b = _f32(torch.from_numpy(want.copy()).to(dt))
            limit = _ulp_bf16(want_b) + 1e-5
            assert np.all(np.abs(got - want_b) <= limit), name


def test_rate0_matches_layer_norm_of_the_sum():
    """At rate 0 the epilogue is torch's LayerNorm of x + sub (fp32)."""
    x, s, w, b, _ = _inputs(32, 256, seed=3)
    xt, st, wt, bt = (torch.from_numpy(a) for a in (x, s, w, b))
    out, _ = fused_add_dropout_ln_fwd(xt, st, wt, bt, 0, 0.0, EPS)
    want = torch.nn.functional.layer_norm(xt + st, (256,), wt, bt, EPS)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_rate_mask_is_the_philox_row_mask_in_both_directions():
    """At rate 0.1 the forward drops exactly the elements of
    ``philox.row_keep(seed, SALT_FUSED_LN)`` (out equals the layer norm of
    x + the masked, scaled sub), and the backward's d(sub) is zero exactly
    there; another seed drops other elements."""
    n, h, seed, rate = 64, 256, 0xC0FFEE, 0.1
    x, s, w, b, g = (torch.from_numpy(a) for a in _inputs(n, h, seed=4))
    keep = philox.row_keep(seed, philox.SALT_FUSED_LN, n, h, rate)
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    out, stats = fused_add_dropout_ln_fwd(x, s, w, b, seed, rate, EPS)
    sub = torch.where(keep, s * philox.keep_scale(rate), 0.0)
    want = torch.nn.functional.layer_norm(x + sub, (h,), w, b, EPS)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    _, dsub, _, _ = fused_add_dropout_ln_bwd(x, s, w, stats, g, seed, rate,
                                             EPS)
    assert torch.equal(dsub != 0, keep)
    other = philox.row_keep(seed + 1, philox.SALT_FUSED_LN, n, h, rate)
    assert not torch.equal(other, keep)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_autograd_of_forward_fp64(rate):
    """The written-out backward against torch.autograd.gradcheck-style
    autograd of the plain forward in fp64, under the same fixed mask:
    dx, d(sub), dw, db within 1e-10."""
    n, h, seed = 16, 128, 99
    x, s, w, b, g = (torch.from_numpy(a).double() for a in
                     _inputs(n, h, seed=5))
    leaves = [t.clone().requires_grad_() for t in (x, s, w, b)]
    out, stats = fused_add_dropout_ln_fwd_reference(*leaves, seed, rate, EPS)
    out.backward(g)
    got = fused_add_dropout_ln_bwd_reference(x, s, w, stats.detach(), g,
                                             seed, rate, EPS)
    for name, a, leaf in zip(("dx", "dsub", "dw", "db"), got, leaves):
        torch.testing.assert_close(a, leaf.grad, atol=1e-10, rtol=1e-10,
                                   msg=name)
    # and the plain forward itself passes gradcheck at this mask
    small = [t[:4, :].clone().requires_grad_() if t.dim() == 2 else
             t.clone().requires_grad_() for t in (x, s, w, b)]
    assert torch.autograd.gradcheck(
        lambda *a: fused_add_dropout_ln_fwd_reference(*a, seed, rate,
                                                      EPS)[0],
        small, eps=1e-6, atol=1e-7)


def test_autograd_function_on_the_cpu_is_uncounted():
    """FusedAddDropoutLN on [B, S, H] tensors: gradients reach x, sub,
    weight and bias (the reference's vjp, reshaped), nothing is counted."""
    x, s, w, b, g = (torch.from_numpy(a) for a in _inputs(24, 128, seed=6))
    leaves = [t.clone().requires_grad_() for t in (x, s, w, b)]
    reset_launch_counts()
    out = FusedAddDropoutLN.apply(leaves[0].view(2, 12, 128),
                                  leaves[1].view(2, 12, 128), leaves[2],
                                  leaves[3], 5, 0.1, EPS)
    out.backward(g.view(2, 12, 128))
    _, stats = fused_add_dropout_ln_fwd(x, s, w, b, 5, 0.1, EPS)
    want = fused_add_dropout_ln_bwd(x, s, w, stats, g, 5, 0.1, EPS)
    for a, leaf in zip(want, leaves):
        torch.testing.assert_close(leaf.grad, a)
    assert launch_counts() == NO_LAUNCHES


def test_add_dropout_ln_routes_by_width():
    """F.add_dropout_ln: the fused function where the width is a multiple
    of 128 (one seed drawn), else LayerNorm(x + dropout(sub)) with the
    dropout kernel's mask; identical at rate 0 and in eval; without a
    generator, the call with one at the global chain's seed."""
    gen = torch.Generator()
    for h in (128, 96):
        x, s, w, b, _ = (torch.from_numpy(a) for a in _inputs(8, h, seed=h))
        eval_out = F.add_dropout_ln(x, s, w, b, p=0.1, training=False)
        want = torch.nn.functional.layer_norm(x + s, (h,), w, b, 1e-12)
        torch.testing.assert_close(eval_out, want, atol=1e-5, rtol=1e-5)
        gen.manual_seed(1)
        a = F.add_dropout_ln(x, s, w, b, p=0.1, generator=gen)
        gen.manual_seed(1)
        again = F.add_dropout_ln(x, s, w, b, p=0.1, generator=gen)
        assert torch.equal(a, again) and not torch.allclose(a, eval_out)
        # without a generator the seed comes from the global chain
        state = get_rng_state()
        seed(2)
        chained = F.add_dropout_ln(x, s, w, b, p=0.1, training=True)
        set_rng_state(state)
        gen.manual_seed(2)
        assert torch.equal(chained, F.add_dropout_ln(x, s, w, b, p=0.1,
                                                     generator=gen))


@pytest.mark.parametrize("bad", ["rate", "dtype", "mixed", "shape"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x = torch.zeros(8, 128)
    w = torch.ones(128)
    if bad == "rate":
        with pytest.raises(ValueError):
            fused_add_dropout_ln_fwd(x, x, w, w, 1, 1.0, EPS)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            fused_add_dropout_ln_fwd(x.half(), x.half(), w.half(), w.half(),
                                     1, 0.1, EPS)
    elif bad == "mixed":
        with pytest.raises(ValueError):
            fused_add_dropout_ln_fwd(x, x, w.bfloat16(), w, 1, 0.1, EPS)
    else:
        with pytest.raises(ValueError):
            fused_add_dropout_ln_fwd(x, x[:4], w, w, 1, 0.1, EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_kernels_match_plain(rate, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    n, h, seed = 4096, 768, 12345
    x, s, w, b, g = (torch.from_numpy(a).cuda().to(dt) for a in
                     _inputs(n, h, seed=7))
    reset_launch_counts()
    out, stats = fused_add_dropout_ln_fwd(x, s, w, b, seed, rate, EPS)
    dx, ds, dw, db = fused_add_dropout_ln_bwd(x, s, w, stats, g, seed, rate,
                                              EPS)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, fused_add_dropout_ln_fwd=1,
                                   fused_add_dropout_ln_bwd=1)
    r_out, r_stats = fused_add_dropout_ln_fwd_reference(x, s, w, b, seed,
                                                        rate, EPS)
    want = fused_add_dropout_ln_bwd_reference(x, s, w, r_stats, g, seed,
                                              rate, EPS)
    keep = philox.row_keep(seed, philox.SALT_FUSED_LN, n, h, rate, "cuda")
    assert torch.equal(ds != 0, keep)
    torch.testing.assert_close(stats, r_stats, atol=1e-6, rtol=1e-5)
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    assert ((out.float() - r_out.float()).abs()
            <= 1e-5 + ulp * r_out.float().abs()).all()
    for a, c in zip((dx, ds, dw, db), want):
        rel = ((a.float() - c.float()).norm() / c.float().norm()).item()
        assert rel < (1e-2 if dt == torch.bfloat16 else 1e-4)
