"""The port's [B, L, H, D] flash attention with grouped-query attention
(paddle_tpu_torch.kernels.flash_attention) against the JAX package's Pallas
kernels, and the attention functionals built on it.

On the CPU each wrapper runs its plain version, which is held in fp32 to
the Pallas kernels in interpret mode with 128 x 128 blocks (as
tests/test_flash_attention.py runs them): the forward's out and lse to
``_flash_fwd``, the backward to ``jax.vjp`` of ``flash_attention_blhd``,
which at L = 128 takes the fused kernel and at L = 256 the split dq/dkv
kernels. The CUDA kernels themselves are held to the plain versions by the
``cuda``-marked tests, which run only where a card is present.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.pallas.flash_attention import (_flash_fwd,
                                                       flash_attention_blhd)
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention

NO_LAUNCHES = {"flash_pair_fwd": 0, "flash_pair_bwd": 0,
               "flash_attention_fwd": 0, "flash_attention_bwd": 0,
               "dropout_fwd": 0, "fused_add_dropout_ln_fwd": 0,
               "fused_add_dropout_ln_bwd": 0}

# (Lq, Lk): one tile pair (the fused backward), two (the split backward),
# and Lq != Lk (the causal diagonal moves by Lk - Lq)
LENGTHS = [(128, 128), (256, 256), (128, 256)]
HEADS = [(4, 4), (4, 2), (4, 1)]        # MHA, GQA, MQA


def _inputs(b, lq, lk, h, hkv, d, seed):
    """q, k ~ N(0, 1.5^2) and v ~ N(0, 1) as fp32 numpy [B, L, H, D]."""
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, lq, h, d) * 1.5).astype(np.float32)
    k = (rs.randn(b, lk, hkv, d) * 1.5).astype(np.float32)
    v = rs.randn(b, lk, hkv, d).astype(np.float32)
    return q, k, v


def _flat(x):
    """[B, L, H, D] -> the Pallas kernels' [B*H, L, D]."""
    b, L, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, L, d))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", HEADS, ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("lengths", LENGTHS, ids=["128", "256", "128x256"])
def test_forward_matches_pallas_interpret(lengths, heads, causal):
    (lq, lk), (h, hkv), b, d = lengths, heads, 2, 64
    q, k, v = _inputs(b, lq, lk, h, hkv, d, seed=lq + lk + h + hkv)
    out_j, lse_j = _flash_fwd(_flat(q), _flat(k), _flat(v),
                              jnp.asarray([0], jnp.int32), causal,
                              1.0 / math.sqrt(d), 128, 128, 0.0, True, h,
                              hkv)
    out_j = np.asarray(out_j).reshape(b, h, lq, d).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j).reshape(b, h, -1)[:, :, :lq]
    out_t, lse_t = flash_attention_fwd_reference(*_t(q, k, v), causal)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4, rtol=1e-4)


def test_forward_row_without_visible_key_is_zero():
    """Causal with Lq > Lk: the first Lq - Lk rows see no key; the output
    there is 0 and the lse -1e30, as the Pallas kernel gives."""
    b, lq, lk, h, hkv, d = 1, 256, 128, 2, 1, 128
    q, k, v = _inputs(b, lq, lk, h, hkv, d, seed=3)
    out_j, lse_j = _flash_fwd(_flat(q), _flat(k), _flat(v),
                              jnp.asarray([0], jnp.int32), True,
                              1.0 / math.sqrt(d), 128, 128, 0.0, True, h,
                              hkv)
    out_t, lse_t = flash_attention_fwd_reference(*_t(q, k, v), True)
    assert torch.count_nonzero(out_t[:, :lq - lk]) == 0
    np.testing.assert_allclose(
        out_t.numpy(),
        np.asarray(out_j).reshape(b, h, lq, d).transpose(0, 2, 1, 3),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        lse_t.numpy(), np.asarray(lse_j).reshape(b, h, -1)[:, :, :lq],
        rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", HEADS, ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("lengths", LENGTHS, ids=["128", "256", "128x256"])
def test_backward_matches_pallas_vjp(lengths, heads, causal):
    """dq, dk, dv from the plain backward (on the plain forward's out and
    lse) against jax.vjp of flash_attention_blhd in interpret mode on the
    same cotangent: the fused kernel at L = 128, the split kernels at L =
    256, GQA's dk/dv summed over each group."""
    (lq, lk), (h, hkv), b, d = lengths, heads, 1, 64
    q, k, v = _inputs(b, lq, lk, h, hkv, d, seed=7 + lq + lk + h + hkv)
    g = np.random.RandomState(lq + hkv).randn(b, lq, h, d).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(a, bb, c, causal=causal,
                                              block_q=128, block_k=128,
                                              interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt, gt = _t(q, k, v, g)
    out, lse = flash_attention_fwd_reference(qt, kt, vt, causal)
    got = flash_attention_bwd_reference(qt, kt, vt, out, lse, gt, causal)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def _plain_chain(q, k, v, causal):
    """Softmax attention by autograd-friendly torch ops, fp32, GQA by
    repeated heads, the causal band aligned bottom-right."""
    rep = q.shape[2] // k.shape[2]
    kf, vf = (t.repeat_interleave(rep, dim=2).transpose(1, 2)
              for t in (k, v))
    s = q.transpose(1, 2) @ kf.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = s.shape[-2:]
        keep = torch.ones(lq, lk, dtype=torch.bool).tril(lk - lq)
        s = s.masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, dim=-1) @ vf).transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_function_matches_autograd_of_plain_chain(heads, causal):
    """FlashAttention.apply on CPU tensors (the wrappers' plain versions)
    against torch.autograd of the softmax chain: out and every input's
    gradient within 1e-5 (fp32, where the rounding points are exact)."""
    h, hkv = heads
    q, k, v = _inputs(2, 160, 192, h, hkv, 64, seed=11)
    g = torch.from_numpy(
        np.random.RandomState(12).randn(2, 160, h, 64).astype(np.float32))
    a = [t.requires_grad_() for t in _t(q, k, v)]
    b = [t.clone().detach().requires_grad_() for t in a]
    reset_launch_counts()
    out = FlashAttention.apply(*a, causal)
    out.backward(g)
    want = _plain_chain(*b, causal)
    want.backward(g)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-5)
    assert launch_counts() == NO_LAUNCHES      # CPU tensors never count


@pytest.mark.parametrize("bad", ["dropout", "head_dim", "gqa_ratio",
                                 "layout", "dtype", "blocks"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 128, 4, 64)
    k = torch.zeros(1, 128, 2, 64)
    if bad == "dropout":
        with pytest.raises(NotImplementedError, match="slice 5"):
            flash_attention_fwd(q, k, k, True, dropout_rate=0.1)
    elif bad == "head_dim":
        with pytest.raises(ValueError):
            flash_attention_fwd(torch.zeros(1, 128, 4, 96),
                                torch.zeros(1, 128, 2, 96),
                                torch.zeros(1, 128, 2, 96), True)
    elif bad == "gqa_ratio":
        k3 = torch.zeros(1, 128, 3, 64)
        with pytest.raises(ValueError):
            flash_attention_fwd(q, k3, k3, True)
    elif bad == "layout":
        nc = torch.zeros(1, 4, 128, 64).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_fwd(nc, k, k, True)
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_bwd(q, k, k, q, torch.zeros(1, 4, 128), nc, True)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_attention_fwd(q.half(), k.half(), k.half(), True)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_attention_fwd(q, k, k, True, block_q=256)


@pytest.mark.parametrize("kw", [dict(kv_lens=torch.tensor([100])),
                                dict(q_segments=torch.zeros(1, 128),
                                     kv_segments=torch.zeros(1, 128)),
                                dict(attn_mask=torch.zeros(1, 1, 128, 128)),
                                dict(dropout_p=0.1)],
                         ids=["kv_lens", "segments", "attn_mask", "dropout"])
def test_sdpa_refuses_masks_and_dropout(kw):
    q = torch.zeros(1, 128, 4, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.scaled_dot_product_attention(q, q, q, **kw)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_gqa_matches_jax(causal):
    """The plain chain with grouped-query attention (4 q heads on 2 KV
    heads) against the JAX package's scaled_dot_product_attention, which
    repeats the KV heads itself (the first repair of this slice: the port
    did not)."""
    q, k, v = _inputs(2, 96, 96, 4, 2, 64, seed=13)
    ref = JF.scaled_dot_product_attention(*map(paddle.to_tensor, (q, k, v)),
                                          is_causal=causal).numpy()
    got = F.scaled_dot_product_attention(*_t(q, k, v), is_causal=causal)
    assert got.shape == (2, 96, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_functionals_route_to_the_kernel_when_the_gate_passes(monkeypatch):
    """With the gate forced open on the CPU, F.flash_attention and the
    no-mask F.scaled_dot_product_attention go through FlashAttention (its
    plain versions here), and so does the packed path when the pair layout
    refuses the head count (3 heads of 64); below the gate the packed path
    takes the softmax chain. Both routes agree with the JAX package's
    flash_attention on the CPU."""
    calls = []
    real = FlashAttention.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(attention.FlashAttention, "apply", spy)
    q, k, v = _inputs(1, 128, 128, 4, 2, 64, seed=14)
    ref = np.asarray(JF.flash_attention(*map(paddle.to_tensor, (q, k, v)),
                                        causal=True).numpy())
    plain = F.flash_attention(*_t(q, k, v), causal=True)
    assert calls == []
    monkeypatch.setattr(attention, "flash_path_available",
                        lambda *a, **kw: True)
    routed = F.flash_attention(*_t(q, k, v), causal=True)
    via_sdpa = F.scaled_dot_product_attention(*_t(q, k, v), is_causal=True)
    qkv = torch.from_numpy(np.tile(_inputs(1, 128, 128, 3, 3, 64, seed=15)
                                   [0].reshape(1, 128, 3 * 64), (1, 1, 3)))
    F.flash_attention_qkv_packed(qkv, 3)
    assert calls == [(1, 128, 4, 64), (1, 128, 4, 64), (1, 128, 3, 64)]
    for got in (plain, routed, via_sdpa):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_flash_attention_refuses_dropout_in_training():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(NotImplementedError, match="slice 5"):
        F.flash_attention(q, q, q, dropout=0.1, training=True)
    F.flash_attention(q, q, q, dropout=0.1, training=False)


# ------------------------------------------------------------------ cuda


def _card_inputs(b, lq, lk, h, hkv, d, dtype, seed):
    """q, k ~ N(0, 2^2), v and dO ~ N(0, 1) on the card (the inputs of
    chip_smoke.py's compare-fa phases)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, lq, h, d) * 2.0
    k = rs.randn(b, lk, hkv, d) * 2.0
    v = rs.randn(b, lk, hkv, d)
    g = rs.randn(b, lq, h, d)
    return [torch.from_numpy(a.astype(np.float32)).cuda().to(dtype)
            for a in (q, k, v, g)]


CARD_CASES = [(2, 512, 512, 8, 2, 128, "bfloat16", True),
              (2, 200, 300, 4, 1, 64, "float32", True),
              (2, 200, 300, 4, 4, 64, "float32", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_cuda_forward_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, lq, lk, h, hkv, d, dt, causal = case
    dtype = getattr(torch, dt)
    q, k, v, _ = _card_inputs(b, lq, lk, h, hkv, d, dtype, seed=21)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_fwd=1)
    ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal)
    atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_cuda_backward_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, lq, lk, h, hkv, d, dt, causal = case
    dtype = getattr(torch, dt)
    q, k, v, g = _card_inputs(b, lq, lk, h, hkv, d, dtype, seed=22)
    out, lse = flash_attention_fwd(q, k, v, causal)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_bwd=1)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    # the limits of chip_smoke.py's compare-fa-bwd phase
    limit = 8.3e-4 if dtype == torch.bfloat16 else 9e-7
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert err < limit, f"{name}: relative error {err:.3g} >= {limit}"
