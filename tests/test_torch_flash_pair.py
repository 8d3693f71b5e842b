"""The port's packed flash-attention forward (paddle_tpu_torch.kernels.
flash_pair) against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version, which is held to
``_pair_fwd`` in interpret mode (as tests/test_flash_pair.py runs it), out
and lse, in fp32. The CUDA kernel itself is held to the plain version by
the ``cuda``-marked test, which runs only where a card is present.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_pair import _pair_fwd
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.flash_pair import (flash_pair_fwd,
                                                 flash_pair_fwd_reference)


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
    assert launch_counts() == {"flash_pair_fwd": 0}


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
    assert launch_counts() == {"flash_pair_fwd": 1}
    ref_out, ref_lse = flash_pair_fwd_reference(x, heads, causal)
    atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
