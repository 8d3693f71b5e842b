"""The port's [B, L, H, D] flash attention with grouped-query attention
(paddle_tpu_torch.kernels.flash_attention) against the JAX package's Pallas
kernels, and the attention functionals built on it.

On the CPU each wrapper runs its plain version, which is held in fp32 to
the Pallas kernels in interpret mode with 128 x 128 blocks (as
tests/test_flash_attention.py runs them): the forward's out and lse to
``_flash_fwd``, the backward to ``jax.vjp`` of ``flash_attention_blhd``,
which at L = 128 takes the fused kernel and at L = 256 the split dq/dkv
kernels. The masks (``kv_lens``, segment ids) are held the same way to
``_flash_fwd`` and the vjp of ``flash_attention_blhd`` with those masks,
mirroring tests/test_flash_masks.py, and the packed-qkv route (row 6) to
the JAX ``flash_attention_qkv_packed``. With dropout the Pallas kernels
draw TPU hardware bits, so the port's dropout is held to its own contract:
the Philox mask of the seed, the same mask on every route, and a padded
batch at full lengths equal to the packed path. The CUDA kernels
themselves are held to the plain versions by the ``cuda``-marked tests,
which run only where a card is present.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.pallas import flash_attention as jfa
from paddle_tpu.kernels.pallas.flash_attention import (_flash_fwd,
                                                       flash_attention_blhd)
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.core.random import (get_rng_state, make_generator,
                                          next_seed, seed, set_rng_state)
from paddle_tpu_torch.kernels import launch_counts, philox, \
    reset_launch_counts, wide_launch_counts, f32_wide_launch_counts, \
    f32_bwd_launch_counts, f32_fwd_launch_counts, sw32_bwd_launch_counts
from paddle_tpu_torch.kernels.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference,
    flash_attention_qkv_packed, kernel_head_dim, pad_head_dim)
from paddle_tpu_torch.kernels.flash_pair import (
    bwd_work_floats, flash_pair_bwd, flash_pair_bwd_reference, flash_pair_fwd,
    flash_pair_fwd_reference, fwd_work_floats)
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
        # dropout runs in-kernel; what is refused is a rate without a seed
        # and a rate outside [0, 1)
        with pytest.raises(ValueError, match="seed"):
            flash_attention_fwd(q, k, k, True, dropout_rate=0.1)
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            flash_attention_fwd(q, k, k, True, dropout_rate=1.0, seed=1)
    elif bad == "head_dim":
        # every head size runs (padded to a built size; above 256 the
        # kernels take any multiple of 64): only an empty head is refused
        with pytest.raises(ValueError, match="empty head"):
            flash_attention_fwd(torch.zeros(1, 128, 4, 0),
                                torch.zeros(1, 128, 2, 0),
                                torch.zeros(1, 128, 2, 0), True)
        assert kernel_head_dim(320) == 320 and kernel_head_dim(300) == 320
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


@pytest.mark.parametrize("kw", [dict(kv_lens=torch.tensor([100, 100])),
                                dict(q_segments=torch.zeros(1, 128)),
                                dict(attn_mask=torch.zeros(1, 1, 128, 128,
                                                           dtype=torch.bool)),
                                dict(dropout_p=1.5)],
                         ids=["kv_lens", "segments", "attn_mask", "dropout"])
def test_sdpa_refuses_masks_and_dropout(kw):
    """The masks and dropout run now (the tests below; dropout without a
    generator draws from the global chain); what sdpa still refuses:
    lengths that are not [B], q segments without kv segments, a bool
    attn_mask (the mask is additive), and a dropout rate above 1."""
    q = torch.zeros(1, 128, 4, 64)
    want = {"kv_lens": (ValueError, "kv_lens"),
            "q_segments": (ValueError, "together"),
            "attn_mask": (TypeError, "additive"),
            "dropout_p": (ValueError, "not in")}[next(iter(kw))]
    with pytest.raises(want[0], match=want[1]):
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


def test_flash_attention_dropout_draws_from_the_global_chain():
    """Training at dropout 0.1 without a generator draws the seed from the
    global chain (after seed(3), the call with make_generator(3)); with
    one, the probabilities drop under the seed it gives (the plain version
    at that seed); eval draws none."""
    q, k, v = _t(*_inputs(1, 128, 128, 2, 2, 64, seed=16))
    state = get_rng_state()
    seed(3)
    chained = F.flash_attention(q, k, v, dropout=0.1, training=True)
    torch.testing.assert_close(
        chained, F.flash_attention(q, k, v, dropout=0.1, training=True,
                                   generator=make_generator(3)))
    advanced = get_rng_state()
    F.flash_attention(q, k, v, dropout=0.1, training=False)
    assert torch.equal(get_rng_state(), advanced)
    set_rng_state(state)
    got = F.flash_attention(q, k, v, dropout=0.1, training=True,
                            generator=make_generator(3))
    want = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                          generator=make_generator(3))
    torch.testing.assert_close(got, want)
    nodrop = F.flash_attention(q, k, v, training=True)
    assert not torch.allclose(got, nodrop)


# ------------------------------------------------- masks, dropout, row 6


def _segments(b, L, cuts):
    """``[B, L]`` int32 segment ids: row ``r`` switches to the next id at
    each position of ``cuts[r]``."""
    seg = np.zeros((b, L), np.int32)
    for r, row in enumerate(cuts):
        for c in row:
            seg[r, c:] += 1
    return seg


# (name, B, L, H, Hkv, causal, kv_lens, segment cuts per row), after the
# cases of tests/test_flash_masks.py; L = 256 takes the split backward
MASK_CASES = [
    ("lens", 3, 256, 2, 2, False, [256, 200, 77], None),
    ("lens_causal", 3, 256, 2, 2, True, [256, 200, 77], None),
    ("gqa_lens", 2, 256, 4, 2, False, [256, 192], None),
    ("gqa_lens_causal", 2, 256, 4, 2, True, [256, 130], None),
    ("segments", 2, 256, 2, 2, False, None, [[100], [200]]),
    ("lens_segments", 2, 256, 2, 2, False, [256, 180], [[128], [128]]),
    ("lens_segments_causal", 2, 256, 2, 1, True, [256, 180],
     [[64, 190], [128]]),
    ("lens_shorter_than_block", 2, 256, 1, 1, False, [40, 100], None),
    ("length_of_one", 2, 128, 2, 2, False, [1, 128], None),
    ("length_of_one_causal", 2, 128, 2, 2, True, [128, 1], None),
]


@pytest.mark.parametrize("case", MASK_CASES, ids=[c[0] for c in MASK_CASES])
def test_masked_plain_versions_match_pallas_interpret(case):
    """kv_lens and segment ids: the plain forward's out and lse against
    ``_flash_fwd`` with the same masks, and the plain backward (on the
    plain forward's out and lse) against jax.vjp of flash_attention_blhd,
    Pallas in interpret mode with 128 x 128 blocks, fp32, atol = rtol =
    1e-4. Keys past a length get exactly zero dk and dv."""
    _, b, L, h, hkv, causal, lens, cuts = case
    d = 64
    q, k, v = _inputs(b, L, L, h, hkv, d, seed=17 + L + h + hkv)
    g = np.random.RandomState(L + hkv).randn(b, L, h, d).astype(np.float32)
    jm, tm = {}, {}
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        jm["kv_lens"] = jnp.asarray(lens)
        tm["kv_lens"] = torch.from_numpy(lens)
    if cuts is not None:
        seg = _segments(b, L, cuts)
        jm["q_segments"] = jm["kv_segments"] = jnp.asarray(seg)
        tm["q_segments"] = tm["kv_segments"] = torch.from_numpy(seg)
    out_j, lse_j = _flash_fwd(
        _flat(q), _flat(k), _flat(v), jnp.asarray([0], jnp.int32), causal,
        1.0 / math.sqrt(d), 128, 128, 0.0, True, h, hkv,
        lens=jm.get("kv_lens"), seg_q=jm.get("q_segments"),
        seg_k=jm.get("kv_segments"))
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(a, bb, c, causal=causal,
                                              block_q=128, block_k=128,
                                              interpret=True, **jm),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt, gt = _t(q, k, v, g)
    out, lse = flash_attention_fwd_reference(qt, kt, vt, causal, **tm)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(out_j).reshape(b, h, L, d).transpose(0, 2, 1, 3),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(lse_j).reshape(b, h, -1)[:, :, :L],
        atol=1e-4, rtol=1e-4)
    got = flash_attention_bwd_reference(qt, kt, vt, out, lse, gt, causal,
                                        **tm)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    if lens is not None:
        for r, n in enumerate(lens):
            assert torch.count_nonzero(got[1][r, n:]) == 0
            assert torch.count_nonzero(got[2][r, n:]) == 0


def _packed_vs_pallas(causal, sm_scale):
    """flash_attention_qkv_packed on CPU tensors against the JAX one in
    interpret mode at rate 0, heads of 128: the packed context and d(qkv)
    from jax.vjp, fp32, atol = rtol = 1e-4; nothing launches."""
    b, L, h, d = 2, 256, 2, 128
    rs = np.random.RandomState(18)
    x = (rs.randn(b, L, 3 * h * d) * 0.6).astype(np.float32)
    g = rs.randn(b, L, h * d).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda a: jfa.flash_attention_qkv_packed(a, h, causal=causal,
                                                 sm_scale=sm_scale,
                                                 interpret=True),
        jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(x).requires_grad_()
    reset_launch_counts()
    out = flash_attention_qkv_packed(leaf, h, causal, sm_scale)
    out.backward(torch.from_numpy(g))
    assert launch_counts() == NO_LAUNCHES
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_packed_qkv_plain_matches_pallas_interpret(causal):
    """Row 6 (flash_attention_qkv_packed: FlashPairPacked, whose plain
    versions run on the CPU) against the JAX flash_attention_qkv_packed in
    interpret mode at the default scale."""
    _packed_vs_pallas(causal, None)


def test_packed_qkv_sm_scale_matches_pallas_interpret():
    """Row 6 with an explicit ``sm_scale`` (the pair wrappers take it for
    this call) against the JAX function with the same scale."""
    _packed_vs_pallas(True, 0.05)


def _column_slices(qkv, h, d):
    """The q, k, v column blocks of packed qkv as contiguous [B, L, H, D]."""
    b, L, _ = qkv.shape
    return [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, L, h, d)
            .contiguous() for i in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_packed_qkv_equals_flat_plain_on_column_slices(causal):
    """Row 6's plain route equals the flat plain versions on the three
    column slices at rate 0.1 with one seed and an explicit scale (the
    same Philox mask on both layouts): out to 1e-6, d(qkv) per block to
    1e-5, fp32."""
    b, L, h, d = 2, 256, 2, 128
    rs = np.random.RandomState(19)
    x = torch.from_numpy((rs.randn(b, L, 3 * h * d) * 0.6)
                         .astype(np.float32))
    g = torch.from_numpy(rs.randn(b, L, h * d).astype(np.float32))
    leaf = x.clone().requires_grad_()
    out = flash_attention_qkv_packed(leaf, h, causal, 0.07, 0.1, 1234)
    out.backward(g)
    q, k, v = _column_slices(x, h, d)
    ref, lse = flash_attention_fwd_reference(q, k, v, causal, 0.07, 0.1,
                                             seed=1234)
    np.testing.assert_allclose(out.detach().numpy(),
                               ref.reshape(b, L, h * d).numpy(), atol=1e-6,
                               rtol=1e-6)
    grads = flash_attention_bwd_reference(q, k, v, ref, lse,
                                          g.reshape(b, L, h, d), causal,
                                          0.07, 0.1, seed=1234)
    want = torch.cat([t.reshape(b, L, h * d) for t in grads], -1)
    np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_packed_qkv_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="head_dim 128"):
        flash_attention_qkv_packed(torch.zeros(1, 128, 3 * 2 * 64), 2)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_qkv_packed(torch.zeros(1, 128, 3 * 128), 1,
                                   dropout_rate=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_qkv_packed(
            torch.zeros(1, 3 * 128, 128).transpose(1, 2), 1)


def _jax_mask(mask):
    return None if mask is None else paddle.to_tensor(mask)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("which", ["attn_mask", "kv_lens", "both"])
def test_sdpa_masks_match_jax(which, causal):
    """sdpa with an additive attn_mask, with kv_lens and with both (GQA 4
    on 2): the plain chain (lengths as a -1e30 additive mask, combined with
    the user's) against the JAX package's scaled_dot_product_attention on
    the CPU, fp32, 1e-5."""
    b, L = 2, 96
    q, k, v = _inputs(b, L, L, 4, 2, 64, seed=19)
    rs = np.random.RandomState(20)
    mask = lens = None
    if which != "kv_lens":
        mask = np.where(rs.rand(b, 1, L, L) < 0.2, -1e4,
                        rs.randn(b, 1, L, L)).astype(np.float32)
    if which != "attn_mask":
        lens = np.array([96, 41], np.int32)
    ref = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), attn_mask=_jax_mask(mask),
        is_causal=causal,
        kv_lens=None if lens is None else paddle.to_tensor(lens)).numpy()
    got = F.scaled_dot_product_attention(
        *_t(q, k, v), is_causal=causal,
        attn_mask=None if mask is None else torch.from_numpy(mask),
        kv_lens=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("masks", ["lens", "segments", "lens_segments"])
def test_sdpa_kernel_route_matches_the_plain_chain(masks, monkeypatch):
    """With the gate forced open on the CPU, sdpa with kv_lens and/or
    segment ids goes through FlashAttention (the kernels' plain versions)
    and gives the JAX package's output for the same call (its additive-mask
    chain on the CPU), and the gradients of the plain chain, fp32, 1e-5;
    at rate 0.1 the same generator state gives the same output on both
    routes."""
    b, L = 2, 128
    q, k, v = _inputs(b, L, L, 4, 2, 64, seed=21)
    kw = {}
    if "lens" in masks:
        kw["kv_lens"] = np.array([128, 77], np.int32)
    if "segments" in masks:
        kw["q_segments"] = kw["kv_segments"] = _segments(b, L, [[30], [60]])
    ref = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)),
        **{n: paddle.to_tensor(a) for n, a in kw.items()}).numpy()
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    g = torch.from_numpy(np.random.RandomState(22).randn(b, L, 4, 64)
                         .astype(np.float32))
    chain = [t.requires_grad_() for t in _t(q, k, v)]
    want = F.scaled_dot_product_attention(*chain, **tkw)
    want.backward(g)
    drop_chain = F.scaled_dot_product_attention(
        *_t(q, k, v), dropout_p=0.1, generator=make_generator(5), **tkw)
    calls = []
    real = FlashAttention.apply
    monkeypatch.setattr(attention.FlashAttention, "apply",
                        lambda *a: calls.append(a[6:]) or real(*a))
    monkeypatch.setattr(attention, "flash_path_available",
                        lambda *a, **kw: True)
    routed = [t.requires_grad_() for t in _t(q, k, v)]
    got = F.scaled_dot_product_attention(*routed, **tkw)
    got.backward(g)
    drop_routed = F.scaled_dot_product_attention(
        *_t(q, k, v), dropout_p=0.1, generator=make_generator(5), **tkw)
    assert len(calls) == 2 and calls[0] == (tkw.get("kv_lens"),
                                            tkw.get("q_segments"),
                                            tkw.get("kv_segments"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for x, y in zip(routed, chain):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(drop_routed, drop_chain, atol=1e-5,
                               rtol=1e-5)
    assert not torch.allclose(drop_routed, got.detach())


def test_dropout_keep_share_and_mask_on_both_routes(monkeypatch):
    """Probe at rate 0.1: q = k = 0 makes every probability 1 / Lk, and v
    of key j is the unit vector e_j (Lk = D = 64), so out[b, i, h, j] is
    nonzero exactly where pair (i, j) is kept. On the plain chain and on
    the kernel route (gate forced open) the kept pairs are those of
    philox.attention_keep, their share within 4 sigma of 0.9, and one
    generator seed gives one output."""
    b, lq, h, d = 2, 256, 4, 64
    rate = 0.1
    q = torch.zeros(b, lq, h, d)
    v = torch.eye(d).reshape(1, d, 1, d).expand(b, d, h, d).contiguous()
    k = torch.zeros(b, d, h, d)
    gen = make_generator(6)
    want = philox.attention_keep(next_seed(gen), b, h, lq, d, rate)
    kept = []
    for gate in (False, True):
        monkeypatch.setattr(attention, "flash_path_available",
                            lambda *a, g=gate, **kw: g)
        outs = [F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate, generator=make_generator(6))
            for _ in range(2)]
        assert torch.equal(outs[0], outs[1])
        got = outs[0].permute(0, 2, 1, 3) != 0          # [b, h, i, j]
        assert torch.equal(got, want)
        kept.append(got.float().mean().item())
    n = want.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(kept[0] - (1 - rate)) < 4 * sigma


@pytest.mark.parametrize("causal", [False, True])
def test_full_lengths_drop_what_the_packed_path_drops(causal):
    """At rate 0.1, the flat plain versions with every kv_lens = L give the
    pair path's plain forward and backward at the same seed (one Philox
    mask keyed on (b, q head, q position, key position)), fp32, 1e-6."""
    b, L, h, d, rate, seed = 2, 128, 2, 64, 0.1, 0x5EED
    rs = np.random.RandomState(23)
    x = torch.from_numpy((rs.randn(b, L, 3 * h * d) * 0.6)
                         .astype(np.float32))
    g = torch.from_numpy(rs.randn(b, L, h * d).astype(np.float32))
    lens = torch.full((b,), L)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, L, h, d)
               .contiguous() for i in range(3))
    out, lse = flash_attention_fwd_reference(q, k, v, causal, None, rate,
                                             seed=seed, kv_lens=lens)
    pair_out, pair_lse = flash_pair_fwd_reference(x, h, causal, rate, seed)
    torch.testing.assert_close(out.reshape(b, L, h * d), pair_out,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, pair_lse, atol=1e-6, rtol=1e-6)
    grads = flash_attention_bwd_reference(
        q, k, v, out, lse, g.reshape(b, L, h, d), causal, None, rate,
        seed=seed, kv_lens=lens)
    pair = flash_pair_bwd_reference(x, pair_out, pair_lse, g, h, causal,
                                    rate, seed)
    torch.testing.assert_close(
        torch.cat([t.reshape(b, L, h * d) for t in grads], -1), pair,
        atol=1e-6, rtol=1e-6)


def test_dropout_seed_and_masks_are_saved_for_the_backward():
    """FlashAttention at rate 0.1 with lengths and segments on the CPU: the
    gradient equals the backward plain version at the forward's seed and
    masks, not at another seed."""
    q, k, v = _t(*_inputs(2, 128, 160, 4, 2, 64, seed=24))
    lens = torch.tensor([160, 90])
    seg_q = torch.from_numpy(_segments(2, 128, [[50], [70]]))
    seg_k = torch.from_numpy(_segments(2, 160, [[60], [80]]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, False, 0.1, 77, lens, seg_q, seg_k)
    g = torch.ones_like(out)
    out.backward(g)
    o, lse = flash_attention_fwd_reference(q, k, v, False, None, 0.1,
                                           seed=77, kv_lens=lens,
                                           q_segments=seg_q,
                                           kv_segments=seg_k)
    torch.testing.assert_close(out.detach(), o)
    want = flash_attention_bwd_reference(q, k, v, o, lse, g, False, None,
                                         0.1, seed=77, kv_lens=lens,
                                         q_segments=seg_q, kv_segments=seg_k)
    other = flash_attention_bwd_reference(q, k, v, o, lse, g, False, None,
                                          0.1, seed=78, kv_lens=lens,
                                          q_segments=seg_q,
                                          kv_segments=seg_k)
    for leaf, w, x in zip(leaves, want, other):
        torch.testing.assert_close(leaf.grad, w)
        assert not torch.allclose(leaf.grad, x)


def test_packed_qkv_split_route_drops_in_the_flat_kernels(monkeypatch):
    """F.flash_attention_qkv_packed with heads the pair layout refuses (3
    of 64), gate forced open, training at 0.1: the heads go to
    FlashAttention with the seed drawn from the generator (the plain
    version here), and the output is the flat plain forward at that
    seed."""
    b, L, h, d = 1, 128, 3, 64
    x = torch.from_numpy(np.random.RandomState(25).randn(b, L, 3 * h * d)
                         .astype(np.float32))
    monkeypatch.setattr(attention, "flash_path_available",
                        lambda *a, **kw: True)
    gen = make_generator(8)
    seed = next_seed(make_generator(8))
    out = F.flash_attention_qkv_packed(x, h, dropout=0.1, causal=True,
                                       training=True, generator=gen)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, L, h, d)
               .contiguous() for i in range(3))
    want, _ = flash_attention_fwd_reference(q, k, v, True, None, 0.1,
                                            seed=seed)
    torch.testing.assert_close(out, want.reshape(b, L, h * d))


# ---------------------------------------------- head sizes, signatures

# built at 80, 96 and 256 besides 64 and 128; 72 runs padded to 80
F1_HEAD_DIMS = [80, 96, 256, 72]
# above 256 every multiple of 64 is built (fp32: csrc/flash_f32_wide.cuh,
# one column slice up to 512)
BIG_HEAD_DIMS = [320, 512]


@pytest.mark.parametrize("d", F1_HEAD_DIMS + BIG_HEAD_DIMS)
def test_head_dims_match_pallas_interpret(d):
    """Every head size the JAX gate sends to a kernel: the plain forward
    (out, lse) against ``_flash_fwd`` and the plain backward against
    jax.vjp of ``flash_attention_blhd``, both in interpret mode, causal
    GQA at L = 128, fp32 within 1e-4."""
    b, L, h, hkv = 1, 128, 4, 2
    q, k, v = _inputs(b, L, L, h, hkv, d, seed=30 + d)
    out_j, lse_j = _flash_fwd(_flat(q), _flat(k), _flat(v),
                              jnp.asarray([0], jnp.int32), True,
                              1.0 / math.sqrt(d), 128, 128, 0.0, True, h,
                              hkv)
    out_t, lse_t = flash_attention_fwd(*_t(q, k, v), True)
    np.testing.assert_allclose(
        out_t.numpy(),
        np.asarray(out_j).reshape(b, h, L, d).transpose(0, 2, 1, 3),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(b, h, -1)[:, :, :L],
                               atol=1e-4, rtol=1e-4)
    g = np.random.RandomState(d).randn(b, L, h, d).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(a, bb, c, causal=True,
                                              block_q=128, block_k=128,
                                              interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_bwd(*_t(q, k, v), out_t, lse_t,
                              torch.from_numpy(g), True)
    for name, x, y in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_big_head_dim_gqa_matches_pallas_interpret(causal):
    """D = 320 (above 256: the kernels of csrc/flash_f32_wide.cuh on the
    card, their plain versions here) with multi-query GQA 4/1 and Lq = 128
    against Lk = 256 (the diagonal moved by 128; two kv tiles: the Pallas
    split dq/dkv kernels), fp32 within 1e-4: out and lse against
    ``_flash_fwd``, dq, dk, dv against jax.vjp of ``flash_attention_blhd``,
    both in interpret mode."""
    b, lq, lk, h, hkv, d = 1, 128, 256, 4, 1, 320
    q, k, v = _inputs(b, lq, lk, h, hkv, d, seed=int(causal) + 320)
    out_j, lse_j = _flash_fwd(_flat(q), _flat(k), _flat(v),
                              jnp.asarray([0], jnp.int32), causal,
                              1.0 / math.sqrt(d), 128, 128, 0.0, True, h,
                              hkv)
    out_t, lse_t = flash_attention_fwd(*_t(q, k, v), causal)
    np.testing.assert_allclose(
        out_t.numpy(),
        np.asarray(out_j).reshape(b, h, lq, d).transpose(0, 2, 1, 3),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(b, h, -1)[:, :, :lq],
                               atol=1e-4, rtol=1e-4)
    g = np.random.RandomState(5).randn(b, lq, h, d).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(a, bb, c, causal=causal,
                                              block_q=128, block_k=128,
                                              interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_bwd(*_t(q, k, v), out_t, lse_t,
                              torch.from_numpy(g), causal)
    for name, x, y in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


# (name, D, Lq, Lk, H, Hkv, causal, kv_lens, segment cuts per row of q) at
# the head sizes of the backward bodies redesigned for Hopper: bf16 80 and
# 96 (csrc/flash_bwd_sm90.cuh on 32-byte swizzle blocks) and fp32 128 (the
# FFMA kernel of csrc/flash_f32_wide.cuh, at every head size up to 256);
# lengths with segment ids, multi-query 4/1, and Lq = 128 against Lk = 256
BODY_CASES = [
    (f"d{d}_{name}", d, lq, lk, h, hkv, causal, lens, cuts)
    for d in (80, 96, 128)
    for name, lq, lk, h, hkv, causal, lens, cuts in (
        ("lens_segments", 256, 256, 4, 2, d != 96, [256, 150],
         [[64, 190], [100]]),
        ("mqa", 256, 256, 4, 1, True, None, None),
        ("ragged", 128, 256, 4, 2, d != 80, None, None))]


@pytest.mark.parametrize("case", BODY_CASES, ids=[c[0] for c in BODY_CASES])
def test_backward_bodies_plain_matches_pallas_vjp(case):
    """The plain backward the redesigned bodies are held to on the card,
    against jax.vjp of ``flash_attention_blhd`` in interpret mode (128 x
    128 blocks: the split dq/dkv kernels at Lk = 256) with the same masks,
    fp32 within 1e-4; keys past a length get exactly zero dk and dv."""
    _, d, lq, lk, h, hkv, causal, lens, cuts = case
    b = 2
    q, k, v = _inputs(b, lq, lk, h, hkv, d, seed=50 + d + lq + hkv)
    g = np.random.RandomState(d + hkv).randn(b, lq, h, d).astype(np.float32)
    jm, tm = {}, {}
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        jm["kv_lens"] = jnp.asarray(lens)
        tm["kv_lens"] = torch.from_numpy(lens)
    if cuts is not None:
        seg = _segments(b, lq, cuts)
        jm["q_segments"] = jm["kv_segments"] = jnp.asarray(seg)
        tm["q_segments"] = tm["kv_segments"] = torch.from_numpy(seg)
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(a, bb, c, causal=causal,
                                              block_q=128, block_k=128,
                                              interpret=True, **jm),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt, gt = _t(q, k, v, g)
    out, lse = flash_attention_fwd(qt, kt, vt, causal, **tm)
    got = flash_attention_bwd(qt, kt, vt, out, lse, gt, causal, **tm)
    for name, x, y in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    for r, n in enumerate(lens if lens is not None else []):
        assert torch.count_nonzero(got[1][r, n:]) == 0
        assert torch.count_nonzero(got[2][r, n:]) == 0


@pytest.mark.parametrize("rate, segments", [(0.0, False), (0.1, False),
                                            (0.1, True)],
                         ids=["0.0", "0.1", "0.1-segments"])
def test_plain_backward_fp64_matches_autograd_of_forward(rate, segments):
    """The plain versions take fp64 (the exact oracle the card's fp32
    kernels above D = 256 are held to): the written-out backward equals
    torch autograd of the fp64 forward under the same masks and dropout,
    GQA 4/2 with lengths at D = 320, and with segment ids (3 a row)."""
    b, lq, lk, h, hkv, d = 2, 96, 128, 4, 2, 320
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in _inputs(b, lq, lk, h, hkv, d, seed=7))
    kw = dict(kv_lens=torch.tensor([128, 70]), seed=11 if rate else None)
    if segments:
        kw.update(_card_masks(b, lq, lk, None, [[30, 60], [20, 70]],
                              device="cpu"))
    out, lse = flash_attention_fwd_reference(q, k, v, True, None, rate, **kw)
    assert out.dtype == lse.dtype == torch.float64
    g = torch.from_numpy(np.random.RandomState(8).randn(*out.shape))
    out.backward(g)
    got = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                        out.detach(), lse.detach(), g, True,
                                        None, rate, **kw)
    for x, leaf in zip(got, (q, k, v)):
        torch.testing.assert_close(x, leaf.grad, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("d", F1_HEAD_DIMS + BIG_HEAD_DIMS)
def test_head_dims_functionals_match_jax(d, monkeypatch):
    """F.scaled_dot_product_attention and F.flash_attention at the new head
    sizes, through the kernel route (the gate forced open: the plain
    versions on the CPU) and the softmax chain, against the JAX package's
    functionals on the CPU, fp32 within 1e-5."""
    q, k, v = _inputs(1, 128, 128, 4, 2, d, seed=40 + d)
    ref = np.asarray(JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), is_causal=True).numpy())
    chain = F.scaled_dot_product_attention(*_t(q, k, v), is_causal=True)
    monkeypatch.setattr(attention, "flash_path_available",
                        lambda *a, **kw: True)
    routed = [F.scaled_dot_product_attention(*_t(q, k, v), is_causal=True),
              F.flash_attention(*_t(q, k, v), causal=True)]
    for got in (chain, *routed):
        assert got.shape == (1, 128, 4, d)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [72, 100, 200, 300])
def test_padded_head_dim_is_exact(d):
    """A head size that is not built runs at ``kernel_head_dim(d)`` on
    zero-padded copies with the true size's scale: the zero columns add
    exact zeros to q.k, give zero output columns, and dO's zero columns
    meet O's, so the sliced forward and backward equal the unpadded ones
    (the plain versions stand in for the kernels here)."""
    kd = kernel_head_dim(d)
    assert kd > d and kd in (80, 128, 256, 320)
    q, k, v = _t(*_inputs(2, 96, 128, 4, 2, d, seed=d))
    g = torch.from_numpy(
        np.random.RandomState(d).randn(2, 96, 4, d).astype(np.float32))
    out, lse = flash_attention_fwd_reference(q, k, v, True)
    pq, pk, pv, pg = (pad_head_dim(t, kd) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(d)
    pout, plse = flash_attention_fwd_reference(pq, pk, pv, True, scale)
    torch.testing.assert_close(pout[..., :d], out, atol=1e-6, rtol=1e-6)
    assert torch.count_nonzero(pout[..., d:]) == 0
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, True)
    got = flash_attention_bwd_reference(pq, pk, pv, pout, plse, pg, True,
                                        scale)
    for x, y in zip(got, want):
        torch.testing.assert_close(x[..., :d], y, atol=1e-6, rtol=1e-6)
        assert torch.count_nonzero(x[..., d:]) == 0


@pytest.mark.parametrize("fn", ["scaled_dot_product_attention",
                                "flash_attention"])
def test_signatures_bind_positionals_as_the_reference(fn):
    """The port's functionals take the JAX package's positional parameters
    in its order, then the port's ``generator``, keyword-only."""
    import inspect
    mine = inspect.signature(getattr(F, fn)).parameters
    ref = list(inspect.signature(getattr(JF, fn)).parameters)
    assert list(mine)[:len(ref)] == ref
    assert list(mine)[len(ref):] == ["generator"]
    assert mine["generator"].kind is inspect.Parameter.KEYWORD_ONLY


def test_sdpa_positional_kv_lens_follows_name():
    """The 9th positional argument of scaled_dot_product_attention is
    kv_lens (after the ignored ``name``), as in the JAX package: the call
    equals the keyword one, and the masked keys change the result."""
    q, k, v = _t(*_inputs(2, 96, 96, 4, 2, 64, seed=17))
    lens = torch.tensor([96, 40])
    pos = F.scaled_dot_product_attention(q, k, v, None, 0.0, True, True,
                                         "attn", lens)
    kw = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                        kv_lens=lens)
    torch.testing.assert_close(pos, kw, rtol=0, atol=0)
    ref = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q.numpy(), k.numpy(), v.numpy())), None,
        0.0, True, True, "attn", paddle.to_tensor(lens.numpy()))
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref.numpy()),
                               atol=1e-5, rtol=1e-5)
    assert not torch.allclose(pos, F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    with pytest.raises(TypeError):
        F.scaled_dot_product_attention(q, k, v, None, 0.0, True, True, None,
                                       None, None, None, None)


def test_flash_attention_options_as_the_reference(monkeypatch):
    """F.flash_attention's reference options: ``return_softmax`` returns
    ``(out, None)``; ``use_pallas=True`` takes the kernel route even below
    the gate (its plain versions on a CPU tensor), False and None the
    softmax chain there, all equal in fp32; ``fixed_seed_offset``,
    ``rng_name`` and ``name`` are ignored; positional order as in the JAX
    package."""
    calls = []
    real = FlashAttention.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(attention.FlashAttention, "apply", spy)
    q, k, v = _t(*_inputs(1, 96, 96, 4, 2, 64, seed=18))
    chain = F.flash_attention(q, k, v, 0.0, True)
    assert calls == []
    out, soft = F.flash_attention(q, k, v, 0.0, True, True, 5, "rng", True,
                                  "attn", True)
    assert soft is None and calls == [(1, 96, 4, 64)]
    off = F.flash_attention(q, k, v, 0.0, True, use_pallas=False)
    assert calls == [(1, 96, 4, 64)]
    for got in (out, off):
        torch.testing.assert_close(got, chain, atol=1e-5, rtol=1e-5)
    ref, ref_soft = JF.flash_attention(
        *map(paddle.to_tensor, (q.numpy(), k.numpy(), v.numpy())), 0.0,
        True, True)
    assert ref_soft is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256, 320, 512])
def test_workspace_sizing_by_dtype(d, dtype):
    """The kernels' fp32 workspaces, sized by type and head size: the bf16
    wide bodies (forward above D = 256, backward from 256) take a bf16
    copy of round(q * scale) (half a float an element); fp32 takes no
    forward workspace and, in the backward, only dq's scratch, lse and
    delta at every head size (the fp32 wide kernels keep O, dK and dV in
    shared memory; the bf16 D = 80, 96 backward keeps dK and dV in
    registers)."""
    b, lq, h = 2, 200, 4
    dt = getattr(torch, dtype)
    lq_pad = 256
    base = b * lq * h * d + 2 * b * h * lq_pad   # dq, lse and delta
    if dtype == "float32":
        assert fwd_work_floats(b, lq, h, d, dt) == 0
        assert bwd_work_floats(b, lq, h, d, dt) == base
    else:
        assert fwd_work_floats(b, lq, h, d, dt) == \
            (b * lq * h * d // 2 if d > 256 else 0)
        assert bwd_work_floats(b, lq, h, d, dt) == \
            base + (b * lq * h * d // 2 if d >= 256 else 0)


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
              (2, 200, 300, 4, 4, 64, "float32", False),
              # the Hopper backward: ragged lengths, multi-query 4/1
              (2, 300, 300, 4, 1, 64, "bfloat16", False),
              (2, 200, 333, 4, 1, 128, "bfloat16", True),
              # heads above 256 (bf16: csrc/flash_wide_sm90.cuh; fp32:
              # csrc/flash_f32_wide.cuh: 1024 in two column slices; at
              # [2, 1024, 4/2, 320] the backward's walks are shared by
              # clusters of 4 CTAs)
              (2, 256, 256, 4, 2, 512, "bfloat16", True),
              (2, 200, 300, 4, 2, 320, "float32", True),
              (1, 128, 200, 2, 1, 512, "float32", False),
              (1, 256, 256, 2, 1, 1024, "float32", True),
              (2, 1024, 1024, 4, 2, 320, "float32", True)]


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
    # the limits of chip_smoke.py's compare-fa-bwd phase; fp32 above D =
    # 256 against the exact gradient (the plain versions in fp64 from fp64
    # inputs) within its BIG_D_FP32_REL_LIMIT: there the fp32 plain
    # version itself sits 3e-6 to 4e-6 from it
    limit = 8.3e-4 if dtype == torch.bfloat16 else 9e-7
    if dtype == torch.float32 and d > 256:
        q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
        o64, l64 = flash_attention_fwd_reference(q64, k64, v64, causal)
        want = flash_attention_bwd_reference(q64, k64, v64, o64, l64, g64,
                                             causal)
        limit = 2.3e-6
    else:
        want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert err < limit, f"{name}: relative error {err:.3g} >= {limit}"


def _card_masks(b, lq, lk, lens, cuts, device="cuda"):
    kw = {}
    if lens is not None:
        kw["kv_lens"] = torch.tensor(lens, dtype=torch.int32, device=device)
    if cuts is not None:
        kw["q_segments"] = torch.from_numpy(_segments(b, lq, cuts)).to(device)
        kw["kv_segments"] = torch.from_numpy(
            _segments(b, lk, [[c * lk // lq for c in row] for row in cuts])
        ).to(device)
    return kw


# (B, Lq, Lk, H, Hkv, D, dtype, causal, kv_lens, segment cuts, rate)
CARD_MASK_CASES = [
    (4, 512, 512, 4, 4, 64, "bfloat16", False, [512, 33, 300, 64], None,
     0.1),
    (2, 512, 512, 8, 2, 128, "bfloat16", True, [512, 100], None, 0.0),
    (2, 200, 300, 4, 2, 64, "float32", True, [300, 77], [[50, 120], [90]],
     0.1),
    (2, 256, 256, 2, 2, 64, "float32", False, [40, 1], None, 0.0),
    # the fp32 wide kernels, ragged, GQA 4/2 (walks shared by clusters of 2)
    (2, 600, 700, 4, 2, 512, "float32", True, [700, 333],
     [[180, 360], [250]], 0.1),
]


def _weighted_limit(q, k, v, causal, out_ref, dtype, **kw):
    """chip_smoke.py's [compare-fa] limit on each output element."""
    atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    weight = flash_attention_fwd_reference(q, k, v.abs(), causal, **kw)[0]
    return atol * weight.float().clamp_min(1.0) + rtol * out_ref.float().abs()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_MASK_CASES)
def test_cuda_masked_kernels_match_plain(case):
    """The flat kernels with lengths, segment ids and dropout against their
    plain versions on the card (the limits of chip_smoke.py's
    [compare-fa-masks]; fp32 above D = 256 the backward against the exact
    gradient); dk and dv are exactly zero past each length; one launch
    each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, lq, lk, h, hkv, d, dt, causal, lens, cuts, rate = case
    dtype = getattr(torch, dt)
    q, k, v, g = _card_inputs(b, lq, lk, h, hkv, d, dtype, seed=23)
    kw = dict(_card_masks(b, lq, lk, lens, cuts), seed=99 if rate else None)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_fwd=1,
                                   flash_attention_bwd=1)
    ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal, None,
                                                     rate, **kw)
    limit = _weighted_limit(q, k, v, causal, ref_out, dtype,
                            dropout_rate=rate, **kw)
    assert bool(((out.float() - ref_out.float()).abs() <= limit).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    bound = 8.3e-4 if dtype == torch.bfloat16 else 9e-7
    if dtype == torch.float32 and d > 256:
        q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
        o64, l64 = flash_attention_fwd_reference(q64, k64, v64, causal, None,
                                                 rate, **kw)
        want = flash_attention_bwd_reference(q64, k64, v64, o64, l64, g64,
                                             causal, None, rate, **kw)
        bound = 2.3e-6
    else:
        want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal,
                                             None, rate, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert err < bound, f"{name}: relative error {err:.3g} >= {bound}"
    for r, n in enumerate(lens):
        assert torch.count_nonzero(got[1][r, n:]) == 0
        assert torch.count_nonzero(got[2][r, n:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rate, sm_scale", [(0.0, None), (0.1, None),
                                            (0.1, 0.05)])
def test_cuda_packed_qkv_matches_plain(rate, sm_scale):
    """Row 6 on the card: flash_attention_qkv_packed at [2, 512, 3*4*128]
    bf16 causal runs the pair kernels (one counted launch each way) and
    matches the flat plain versions on the three column slices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, h, d = 2, 512, 4, 128
    rs = np.random.RandomState(24)
    x = torch.from_numpy(rs.randn(b, L, 3 * h * d).astype(np.float32))
    x[..., :2 * h * d] *= 2.0
    x = x.cuda().to(torch.bfloat16)
    g = torch.from_numpy(rs.randn(b, L, h * d).astype(np.float32)).cuda() \
        .to(torch.bfloat16)
    seed = 7 if rate else None
    leaf = x.clone().requires_grad_()
    reset_launch_counts()
    out = flash_attention_qkv_packed(leaf, h, True, sm_scale, rate, seed)
    out.backward(g)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_pair_fwd=1,
                                   flash_pair_bwd=1)
    q, k, v = _column_slices(x, h, d)
    ref, lse = flash_attention_fwd_reference(q, k, v, True, sm_scale, rate,
                                             seed=seed)
    limit = _weighted_limit(q, k, v, True, ref, torch.bfloat16,
                            sm_scale=sm_scale, seed=seed, dropout_rate=rate)
    assert bool(((out.detach().float() - ref.reshape(b, L, h * d).float())
                 .abs() <= limit.reshape(b, L, h * d)).all())
    grads = flash_attention_bwd_reference(
        q, k, v, out.detach().reshape(b, L, h, d), lse,
        g.reshape(b, L, h, d), True, sm_scale, rate, seed=seed)
    for i, want in enumerate(grads):
        got = leaf.grad[..., i * h * d:(i + 1) * h * d].float()
        want = want.reshape(b, L, h * d).float()
        assert ((got - want).norm() / want.norm()).item() < 8.3e-4


# (flag set, causal, kv_lens, segment cuts, rate) for the bf16 forward
CARD_FLAG_CASES = [("plain", True, None, None, 0.0),
                   ("lengths", False, [512, 97], None, 0.0),
                   ("segments", True, [512, 300], [[128, 300], [200]], 0.0),
                   ("dropout", False, [512, 400], None, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", CARD_FLAG_CASES, ids=[c[0] for c in
                                                       CARD_FLAG_CASES])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256, 72, 320, 384, 448, 512,
                               300])
def test_cuda_bf16_forward_every_head_dim_and_flag(d, flags):
    """The bf16 Hopper forwards (up to 256 flash_fwd_sm90.cuh's, above
    flash_wide_sm90.cuh's; 72 and 300: run at 80 and 320 on zero-padded
    heads) at each built head size and each flag combination (causal,
    lengths, segment ids, dropout) against their plain version, at
    chip_smoke.py's [compare-fa] limits; one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, causal, lens, cuts, rate = flags
    b, L, h, hkv = 2, 512, 4, 2
    q, k, v, _ = _card_inputs(b, L, L, h, hkv, d, torch.bfloat16, seed=d)
    kw = dict(_card_masks(b, L, L, lens, cuts), seed=5 if rate else None)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_fwd=1)
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal, None,
                                                 rate, **kw)
    limit = _weighted_limit(q, k, v, causal, ref, torch.bfloat16,
                            dropout_rate=rate, **kw)
    assert bool(((out.float() - ref.float()).abs() <= limit).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


# (flag set, causal, kv_lens, segment cuts, rate) for the bf16 backward:
# a length below one tile, segment ids, dropout with lengths
CARD_BWD_FLAG_CASES = [("plain", True, None, None, 0.0),
                       ("bidirectional", False, None, None, 0.0),
                       ("lengths", True, [512, 40], None, 0.0),
                       ("segments", True, [512, 300], [[128, 300], [200]],
                        0.0),
                       ("dropout", False, [512, 97], None, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", CARD_BWD_FLAG_CASES,
                         ids=[c[0] for c in CARD_BWD_FLAG_CASES])
@pytest.mark.parametrize("d", [64, 128, 80, 96, 256, 320, 384, 448, 512,
                               300])
def test_cuda_bf16_backward_every_head_dim_and_flag(d, flags):
    """The bf16 backward at every body's head sizes (64, 80, 96 and 128:
    the Hopper body, 80 and 96 on 32-byte swizzle blocks; 256 and above:
    the wide body; 300 runs at 320 on zero-padded heads), GQA 4/2 at a
    ragged L = 500 (not a multiple of a tile), against its
    plain version at chip_smoke.py's [compare-fa-bwd] limit; dk and dv
    zero past each length, equal between two launches; one counted
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, causal, lens, cuts, rate = flags
    b, L, h, hkv = 2, 500, 4, 2
    q, k, v, g = _card_inputs(b, L, L, h, hkv, d, torch.bfloat16, seed=d + 1)
    kw = dict(_card_masks(b, L, L, lens, cuts), seed=6 if rate else None)
    out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate,
                                **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_bwd=2)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal, None,
                                         rate, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert err < 8.3e-4, f"{name}: relative error {err:.3g}"
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    for r, n in enumerate(lens or []):
        assert torch.count_nonzero(got[1][r, n:]) == 0
        assert torch.count_nonzero(got[2][r, n:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flags", CARD_BWD_FLAG_CASES,
                         ids=[c[0] for c in CARD_BWD_FLAG_CASES])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_cuda_fp32_backward_every_head_dim_and_flag(d, flags):
    """The fp32 backward up to 256 (flash_bwd_f32_kernel of
    csrc/flash_f32_wide.cuh) at every built head size and flag, GQA 4/2 at
    a ragged L = 500, against its fp32 plain version at chip_smoke.py's
    [compare-fa-bwd] limit (its scores are the forward's sums, bit for
    bit); dk and dv zero past each length, equal between two launches; two
    counted launches of that body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, causal, lens, cuts, rate = flags
    b, L, h, hkv = 2, 500, 4, 2
    q, k, v, g = _card_inputs(b, L, L, h, hkv, d, torch.float32, seed=d + 2)
    kw = dict(_card_masks(b, L, L, lens, cuts), seed=7 if rate else None)
    out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate,
                                **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_bwd=2)
    assert f32_bwd_launch_counts() == dict(flash_pair_bwd=0,
                                           flash_attention_bwd=2)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal, None,
                                         rate, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x - y).norm() / y.norm()).item()
        assert err < 9e-7, f"{name}: relative error {err:.3g}"
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    for r, n in enumerate(lens or []):
        assert torch.count_nonzero(got[1][r, n:]) == 0
        assert torch.count_nonzero(got[2][r, n:]) == 0


# (flag set, causal, kv_lens, segment cuts, rate) for the fp32 forward up
# to 256: causal and not, rates 0 and 0.1, with lengths (one below a
# tile) and with segment ids
CARD_F32_FWD_FLAG_CASES = [
    ("causal", True, None, None, 0.0),
    ("bidirectional-dropout", False, None, None, 0.1),
    ("lengths-causal-dropout", True, [500, 40], None, 0.1),
    ("lengths", False, [500, 97], None, 0.0),
    ("segments-causal", True, [500, 300], [[128, 300], [200]], 0.0),
    ("segments-dropout", False, [500, 300], [[128, 300], [200]], 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", CARD_F32_FWD_FLAG_CASES,
                         ids=[c[0] for c in CARD_F32_FWD_FLAG_CASES])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_cuda_fp32_forward_every_head_dim_and_flag(d, flags):
    """The fp32 forward up to 256 (flash_fwd_f32_small_kernel of
    csrc/flash_f32_wide.cuh) at every built head size and flag, GQA 4/2 at
    a ragged L = 500, against its fp32 plain version at chip_smoke.py's
    [compare-fa] limits (out atol = rtol = 1e-4 on the probability-weighted
    |v|, lse 1e-3), one counted launch of that body; the fp32 backward
    that follows it within [compare-fa-bwd]'s 9e-7 of its plain version
    (the backward recomputes this forward's scores bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, causal, lens, cuts, rate = flags
    b, L, h, hkv = 2, 500, 4, 2
    q, k, v, g = _card_inputs(b, L, L, h, hkv, d, torch.float32, seed=d + 3)
    kw = dict(_card_masks(b, L, L, lens, cuts), seed=8 if rate else None)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_fwd=1)
    assert f32_fwd_launch_counts() == dict(flash_pair_fwd=0,
                                           flash_attention_fwd=1)
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal, None,
                                                 rate, **kw)
    limit = _weighted_limit(q, k, v, causal, ref, torch.float32,
                            dropout_rate=rate, **kw)
    assert bool(((out - ref).abs() <= limit).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate, **kw)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal, None,
                                         rate, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x - y).norm() / y.norm()).item()
        assert err < 9e-7, f"{name}: relative error {err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 256])
def test_cuda_functionals_run_a_kernel_at_new_head_dims(d):
    """The three attention functionals at head sizes 96 and 256 on the card
    (the packed one at 256, the pair kernels' size): each runs its kernels
    forward and backward (counted launches) and matches the plain versions
    (forward at [compare-fa]'s limits, gradients within 8.3e-4 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, L, h = 2, 256, 4
    q, k, v, g = _card_inputs(b, L, L, h, h, d, torch.bfloat16, seed=50 + d)
    calls = [("sdpa", lambda a, bb, c: F.scaled_dot_product_attention(
                  a, bb, c, is_causal=True)),
             ("flash", lambda a, bb, c: F.flash_attention(a, bb, c,
                                                          causal=True))]
    if d == 256:
        calls.append(("packed", None))
    for name, fn in calls:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        reset_launch_counts()
        if name == "packed":
            qkv = torch.cat([t.reshape(b, L, h * d) for t in leaves], -1)
            out = F.flash_attention_qkv_packed(qkv, h, causal=True)
            out = out.reshape(b, L, h, d)
        else:
            out = fn(*leaves)
        out.backward(g)
        torch.cuda.synchronize()
        want = dict(flash_pair_fwd=1, flash_pair_bwd=1) if name == "packed" \
            else dict(flash_attention_fwd=1, flash_attention_bwd=1)
        assert launch_counts() == dict(NO_LAUNCHES, **want), name
        ref, lse = flash_attention_fwd_reference(q, k, v, True)
        limit = _weighted_limit(q, k, v, True, ref, torch.bfloat16)
        assert bool(((out.detach().float() - ref.float()).abs()
                     <= limit).all()), name
        grads = flash_attention_bwd_reference(q, k, v, out.detach(), lse, g,
                                              True)
        for leaf, w in zip(leaves, grads):
            err = ((leaf.grad.float() - w.float()).norm()
                   / w.float().norm()).item()
            assert err < 8.3e-4, (name, err)


# (B, Lq, Lk, H, Hkv, D, causal, kv_lens): multi-query 4/1 and ragged Lq !=
# Lk on the wide bodies, both ways
CARD_WIDE_CASES = [(2, 200, 333, 4, 1, 512, True, None),
                   (2, 333, 200, 4, 1, 320, False, None),
                   (2, 300, 300, 4, 1, 384, True, [300, 40]),
                   (1, 130, 260, 2, 1, 448, False, [260])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_WIDE_CASES)
def test_cuda_bf16_wide_heads_mqa_and_ragged(case):
    """The wide bodies (csrc/flash_wide_sm90.cuh) at multi-query 4/1 and Lq
    != Lk, against their plain versions at [compare-fa]'s and
    [compare-fa-bwd]'s limits; dk and dv zero past each length; one
    counted launch each way, both counted as wide-body launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, lq, lk, h, hkv, d, causal, lens = case
    q, k, v, g = _card_inputs(b, lq, lk, h, hkv, d, torch.bfloat16,
                              seed=d + lq)
    kw = _card_masks(b, lq, lk, lens, None)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, flash_attention_fwd=1,
                                   flash_attention_bwd=1)
    assert wide_launch_counts() == dict(
        flash_pair_fwd=0, flash_pair_bwd=0, flash_attention_fwd=1,
        flash_attention_bwd=1)
    ref, ref_lse = flash_attention_fwd_reference(q, k, v, causal, **kw)
    limit = _weighted_limit(q, k, v, causal, ref, torch.bfloat16, **kw)
    assert bool(((out.float() - ref.float()).abs() <= limit).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = ((x.float() - y.float()).norm() / y.float().norm()).item()
        assert err < 8.3e-4, f"{name}: relative error {err:.3g}"
    for r, n in enumerate(lens or []):
        assert torch.count_nonzero(got[1][r, n:]) == 0
        assert torch.count_nonzero(got[2][r, n:]) == 0


# (launcher, D, dtype, the forward's and the backward's body as the
# profiler names them, the body counter of each launch or None: "wide",
# the bf16 wide bodies'; "f32_wide", the fp32 wide ones'; "f32_fwd" and
# "f32_bwd", the fp32 forward's and backward's up to 256; "sw32_bwd", the
# bf16 backward's at 80 and 96)
CARD_ROUTES = [("flat", 512, "bfloat16", "flash_fwd_wide_kernel",
                "flash_bwd_wide_kernel", "wide", "wide"),
               ("pair", 384, "bfloat16", "flash_fwd_wide_kernel",
                "flash_bwd_wide_kernel", "wide", "wide"),
               ("flat", 256, "bfloat16", "flash_fwd_sm90_kernel",
                "flash_bwd_wide_kernel", None, "wide"),
               ("pair", 256, "bfloat16", "flash_fwd_sm90_kernel",
                "flash_bwd_wide_kernel", None, "wide"),
               ("flat", 320, "float32", "flash_fwd_f32_wide_kernel",
                "flash_bwd_f32_wide_kernel", "f32_wide", "f32_wide"),
               ("pair", 384, "float32", "flash_fwd_f32_wide_kernel",
                "flash_bwd_f32_wide_kernel", "f32_wide", "f32_wide"),
               ("flat", 128, "float32", "flash_fwd_f32_small_kernel",
                "flash_bwd_f32_kernel", "f32_fwd", "f32_bwd"),
               ("pair", 128, "float32", "flash_fwd_f32_small_kernel",
                "flash_bwd_f32_kernel", "f32_fwd", "f32_bwd"),
               ("flat", 80, "bfloat16", "flash_fwd_sm90_kernel",
                "flash_bwd_sm90_kernel", None, "sw32_bwd"),
               ("flat", 96, "bfloat16", "flash_fwd_sm90_kernel",
                "flash_bwd_sm90_kernel", None, "sw32_bwd")]
BODIES = ("flash_fwd_sm90_kernel", "flash_fwd_wide_kernel",
          "flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
          "flash_fwd_f32_small_kernel",
          "flash_bwd_sm90_kernel", "flash_bwd_wide_kernel",
          "flash_bwd_f32_kernel", "flash_bwd_f32_wide_kernel")
BODY_COUNTERS = {"wide": wide_launch_counts,
                 "f32_wide": f32_wide_launch_counts,
                 "f32_fwd": f32_fwd_launch_counts,
                 "f32_bwd": f32_bwd_launch_counts,
                 "sw32_bwd": sw32_bwd_launch_counts}


@pytest.mark.cuda
@pytest.mark.parametrize("route", CARD_ROUTES,
                         ids=[f"{r[0]}-{r[1]}" + ("-fp32" * (r[2] == "float32"))
                              for r in CARD_ROUTES])
def test_cuda_bf16_wide_heads_run_the_wide_bodies(route):
    """Which body a launch runs, read from the profiler's kernel names: bf16
    heads above 256 on both launchers run the wide forward and backward
    (csrc/flash_wide_sm90.cuh); the bf16 D = 256 backward runs the wide
    body beside the Hopper forward; fp32 heads above 256 on both launchers
    run the fp32 wide kernels (csrc/flash_f32_wide.cuh), and fp32 at 128
    flash_fwd_f32_small_kernel and flash_bwd_f32_kernel of that header
    (never the SIMT forward, flash_fwd_f32_kernel); the bf16
    backward at 80 and 96 runs the Hopper body at that size. The
    wrappers' body counters agree: 1 for the body that ran, 0 for every
    other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile
    launcher, d, dt, fwd_body, bwd_body, ctr_f, ctr_b = route
    dtype = getattr(torch, dt)
    b, L, h = 2, 256, 4
    if launcher == "flat":
        q, k, v, g = _card_inputs(b, L, L, h, 2, d, dtype, seed=d)
        names = ("flash_attention_fwd", "flash_attention_bwd")

        def run():
            out, lse = flash_attention_fwd(q, k, v, True)
            flash_attention_bwd(q, k, v, out, lse, g, True)
    else:
        rs = np.random.RandomState(d)
        x = torch.from_numpy(rs.randn(b, L, 3 * h * d).astype(np.float32))
        x = x.cuda().to(dtype)
        g = torch.from_numpy(rs.randn(b, L, h * d).astype(np.float32)) \
            .cuda().to(dtype)
        names = ("flash_pair_fwd", "flash_pair_bwd")

        def run():
            out, lse = flash_pair_fwd(x, h, True)
            flash_pair_bwd(x, out, lse, g, h, True)
    run()
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()]
    seen = {n for n in BODIES if any(n in key for key in keys)}
    assert seen == {fwd_body, bwd_body}, keys
    if bwd_body == "flash_bwd_sm90_kernel":
        assert any(f"flash_bwd_sm90_kernel<{d}," in key for key in keys), keys
    assert launch_counts() == dict(NO_LAUNCHES, **{names[0]: 1, names[1]: 1})
    for ctr, reader in BODY_COUNTERS.items():
        want = {n: int((ctr, n) in ((ctr_f, names[0]), (ctr_b, names[1])))
                for n in reader()}
        assert reader() == want, ctr
