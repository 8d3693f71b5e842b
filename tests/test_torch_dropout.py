"""The port's dropout: the Philox4x32-10 bits (paddle_tpu_torch.kernels.
philox), the dropout kernel's plain version (kernels.dropout),
``F.dropout`` and the ``Dropout`` layer, against the Random123 known
answers and the JAX package's semantics.

The JAX package draws its masks from the TPU's hardware PRNG or from
``jax.random``, which no port can reproduce; so the masks are checked for
what they must be (a pure function of seed and element, keep share within
5 sigma of 1 - rate, the gradient is the forward's mask times the scale),
and the JAX package is the reference where the result does not depend on
the bits (eval, ``downscale_in_infer``). The CUDA kernel is held to its
plain version bit for bit by the ``cuda``-marked tests.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch
from paddle_tpu_torch.core.random import (get_rng_state, make_generator,
                                          next_seed, set_rng_state)
from paddle_tpu_torch.kernels import launch_counts, philox, \
    reset_launch_counts
from paddle_tpu_torch.kernels.dropout import (DropoutFunction, dropout_fwd,
                                              dropout_fwd_reference)
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as F

NO_LAUNCHES = {"flash_pair_fwd": 0, "flash_pair_bwd": 0,
               "flash_attention_fwd": 0, "flash_attention_bwd": 0,
               "dropout_fwd": 0, "fused_add_dropout_ln_fwd": 0,
               "fused_add_dropout_ln_bwd": 0}

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    got = philox.philox4x32(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_on_tensors_matches_scalars():
    """The int64 tensor arithmetic gives each element the words of its
    own scalar call (broadcast counters, no cross-talk)."""
    c0 = torch.tensor([0, 7, M32])
    c1 = torch.tensor([[1], [M32]])
    words = philox.philox4x32(c0, c1, 5, 9, 0xDEADBEEF, 0x12345678)
    for i in range(2):
        for j in range(3):
            one = philox.philox4x32(int(c0[j]), int(c1[i, 0]), 5, 9,
                                    0xDEADBEEF, 0x12345678)
            assert [int(w[i, j]) for w in words] == [int(w) for w in one]


def test_masks_do_not_depend_on_tiling():
    """A row mask cut out of a larger call equals the mask drawn for those
    rows alone (row0), and an attention mask's [b, h, i, j] entry is the
    same whatever the batch and length around it."""
    seed, rate = 0x1234_5678_9ABC, 0.3
    full = philox.row_keep(seed, philox.SALT_DROPOUT, 96, 70, rate)
    for r0, r1 in ((0, 1), (5, 37), (64, 96)):
        part = philox.row_keep(seed, philox.SALT_DROPOUT, r1 - r0, 70, rate,
                               row0=r0)
        assert torch.equal(part, full[r0:r1])
    assert torch.equal(
        philox.row_keep(seed, philox.SALT_DROPOUT, 96, 64, rate),
        full[:, :64])                          # 4-column groups stay put
    big = philox.attention_keep(seed, 2, 3, 64, 64, rate)
    small = philox.attention_keep(seed, 1, 3, 16, 40, rate)
    assert torch.equal(small, big[:1, :, :16, :40])
    # other salts, other bits
    assert not torch.equal(
        philox.row_keep(seed, philox.SALT_FUSED_LN, 96, 70, rate), full)


def test_next_seed_is_reproducible_and_cpu_only():
    g1, g2 = make_generator(5), make_generator(5)
    a = [next_seed(g1) for _ in range(4)]
    assert a == [next_seed(g2) for _ in range(4)]
    assert len(set(a)) == 4 and all(0 <= s < 2 ** 63 for s in a)
    with pytest.raises(TypeError):
        next_seed(5)


def _x(shape, seed=0, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x[x == 0] = 1.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_within_five_sigma(rate):
    x = _x((64, 1024))
    out = dropout_fwd(x, 77, rate)
    share = (out != 0).float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    assert abs(share - (1 - rate)) < 5 * sigma
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / (1 - rate))


def test_same_seed_same_mask_other_seed_other_mask():
    x = _x((32, 256))
    a, b, c = (dropout_fwd(x, s, 0.2) for s in (11, 11, 12))
    assert torch.equal(a, b)
    assert not torch.equal(a != 0, c != 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_is_the_forward_mask_times_scale(dtype):
    """x.grad of DropoutFunction is keep * scale (the backward is the same
    function on the cotangent with the saved seed)."""
    dt = getattr(torch, dtype)
    x = _x((8, 16, 128), dtype=dt).requires_grad_()
    reset_launch_counts()
    out = DropoutFunction.apply(x, 42, 0.25, True)
    out.sum().backward()
    keep = philox.row_keep(42, philox.SALT_DROPOUT, 128, 128,
                           0.25).reshape(x.shape)
    want = torch.where(keep, torch.tensor(1 / 0.75), 0.0).to(dt)
    assert torch.equal(x.grad, want)
    assert torch.equal(out != 0, keep)
    assert launch_counts() == NO_LAUNCHES      # CPU tensors never count


def test_plain_version_rounds_like_the_kernel():
    """bf16 in, x * scale in fp32, rounded once to bf16."""
    x = _x((4, 128), dtype=torch.bfloat16)
    out = dropout_fwd_reference(x, 3, 0.1)
    keep = out != 0
    want = (x.float() * philox.keep_scale(0.1)).to(torch.bfloat16)
    assert torch.equal(out[keep], want[keep])


def test_eval_and_zero_rate_are_the_identity():
    x = _x((4, 64))
    assert F.dropout(x, 0.5, training=False) is x
    assert F.dropout(x, 0.0, training=True) is x
    layer = Dropout(0.3).eval()
    assert layer(x) is x


def test_downscale_in_infer_matches_jax():
    """mode="downscale_in_infer": x * (1 - p) in eval (the JAX package's
    F.dropout), kept elements unscaled in training."""
    x = _x((4, 64))
    want = np.asarray(JF.dropout(paddle.to_tensor(x.numpy()), p=0.3,
                                 training=False,
                                 mode="downscale_in_infer").numpy())
    got = F.dropout(x, 0.3, training=False, mode="downscale_in_infer")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    out = F.dropout(x, 0.3, mode="downscale_in_infer",
                    generator=make_generator(1))
    kept = out != 0
    assert torch.equal(out[kept], x[kept])


@pytest.fixture
def chain():
    """Leaves the global chain as the test found it."""
    state = get_rng_state()
    yield
    set_rng_state(state)


def test_training_without_a_generator_draws_from_the_global_chain(chain):
    """F.dropout and Dropout without a generator draw from the global
    chain: after seed(s) they drop what the same call with
    generator=make_generator(s) drops, and the chain advances a call."""
    x = _x((16, 128))
    assert paddle_tpu_torch.seed(5) == 5
    a = F.dropout(x, 0.1, training=True)
    b = F.dropout(x, 0.1, training=True)
    assert torch.equal(a, F.dropout(x, 0.1, generator=make_generator(5)))
    assert not torch.equal(a, b)
    paddle_tpu_torch.seed(6)
    layer = Dropout(0.1)
    assert torch.equal(layer(x), Dropout(0.1, generator=make_generator(6))(x))
    state = paddle_tpu_torch.get_rng_state()
    again = layer(x)
    paddle_tpu_torch.set_rng_state(state)
    assert torch.equal(layer(x), again)
    paddle_tpu_torch.seed(7)
    axis = F.dropout(x, 0.5, axis=0)
    assert torch.equal(axis, F.dropout(x, 0.5, axis=0,
                                       generator=make_generator(7)))


def _dropping_calls():
    """The four functionals that drop at a positive rate, each at 0.1 on
    small CPU inputs: {name: call(**generator keyword)}."""
    x = _x((16, 128))
    q, k, v = (_x((1, 128, 2, 64), seed=s) for s in (1, 2, 3))
    qkv = _x((1, 128, 3 * 2 * 64), seed=4)
    return {
        "dropout": lambda **kw: F.dropout(x, 0.1, **kw),
        "scaled_dot_product_attention":
            lambda **kw: F.scaled_dot_product_attention(q, k, v,
                                                        dropout_p=0.1, **kw),
        "flash_attention":
            lambda **kw: F.flash_attention(q, k, v, dropout=0.1, **kw),
        "flash_attention_qkv_packed":
            lambda **kw: F.flash_attention_qkv_packed(qkv, 2, dropout=0.1,
                                                      **kw)}


@pytest.mark.parametrize("name", ["dropout", "scaled_dot_product_attention",
                                  "flash_attention",
                                  "flash_attention_qkv_packed"])
def test_functionals_draw_from_the_global_chain(name, chain):
    """Each dropping functional runs at a positive rate without a
    generator, repeats itself after the same seed(s), and equals the call
    with generator=make_generator(s); the next call drops other
    elements."""
    call = _dropping_calls()[name]
    paddle_tpu_torch.seed(21)
    a = call()
    paddle_tpu_torch.seed(21)
    b = call()
    assert torch.equal(a, b)
    assert torch.equal(a, call(generator=make_generator(21)))
    assert not torch.equal(a, call())


def test_global_chain_keep_share_matches_the_reference(chain):
    """paddle_tpu.seed(s) / paddle_tpu_torch.seed(s), then F.dropout at p =
    0.1 in each package: both keep shares within 5 sigma of 0.9, the kept
    values x / 0.9 (the bits differ between the packages; the
    distribution and the scaling do not)."""
    x = _x((64, 1024))
    paddle.seed(123)
    ref = np.asarray(JF.dropout(paddle.to_tensor(x.numpy()), p=0.1).numpy())
    paddle_tpu_torch.seed(123)
    got = F.dropout(x, 0.1).numpy()
    sigma = math.sqrt(0.1 * 0.9 / x.numel())
    for out in (ref, got):
        kept = out != 0
        assert abs(kept.mean() - 0.9) < 5 * sigma
        np.testing.assert_allclose(out[kept], x.numpy()[kept] / 0.9,
                                   rtol=1e-6)


def test_layer_and_functional_replay_from_the_generator_state():
    """Dropout(p, generator=g): the same generator state gives the same
    mask, and the generator advances by one seed per call."""
    g = make_generator(9)
    layer = Dropout(0.4, generator=g)
    x = _x((16, 128))
    state = g.get_state()
    a = layer(x)
    b = layer(x)
    g.set_state(state)
    assert torch.equal(layer(x), a) and not torch.equal(a, b)


def test_axis_form_broadcasts_one_mask():
    """axis=[0]: one keep decision per index of axis 0, shared along the
    other axes (torch.bernoulli from the generator)."""
    x = _x((64, 32))
    out = F.dropout(x, 0.5, axis=0, generator=make_generator(2))
    rows_kept = (out != 0).all(dim=1)
    rows_dropped = (out == 0).all(dim=1)
    assert bool((rows_kept | rows_dropped).all())
    assert 0 < int(rows_kept.sum()) < 64
    torch.testing.assert_close(out[rows_kept], x[rows_kept] * 2.0)


@pytest.mark.parametrize("bad", ["rate", "dtype", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 128)
    if bad == "rate":
        with pytest.raises(ValueError):
            dropout_fwd(x, 1, 1.0)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            dropout_fwd(x.half(), 1, 0.1)
    else:
        with pytest.raises(ValueError):
            dropout_fwd(x, -1, 0.1)            # a seed is 64-bit unsigned


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 512, 768), (3, 50)])
def test_cuda_kernel_matches_plain_bit_for_bit(shape, dtype):
    """The kernel against its plain version: the same values bit for bit
    (a ragged last axis takes the kernel's scalar path), and the backward
    launch drops the forward's elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    x = _x(shape, dtype=dt).cuda()
    reset_launch_counts()
    out = dropout_fwd(x, 0xDEADBEEF1, 0.1)
    torch.cuda.synchronize()
    assert launch_counts() == dict(NO_LAUNCHES, dropout_fwd=1)
    assert torch.equal(out, dropout_fwd_reference(x, 0xDEADBEEF1, 0.1))
    leaf = x.clone().requires_grad_()
    DropoutFunction.apply(leaf, 0xDEADBEEF1, 0.1, True).sum().backward()
    assert torch.equal(leaf.grad != 0, out != 0)
