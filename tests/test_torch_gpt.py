"""The port's GPT (paddle_tpu_torch.models.gpt) against the JAX package's,
on the same weights, in fp32 on the CPU: weight conversion, the uncached
scoring logits, the loss, the init recipe, device resolution and import
hygiene."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)


def _spread_weights(jm, seed):
    """Give the JAX model weights at a scale where context matters and
    return them as numpy: matrices ~ N(0, 1/fan_in), so every block adds
    O(1) to the residual stream, embeddings ~ N(0, 0.2^2), so the token's
    own embedding does not drown the attention, and LayerNorm weights and
    biases near their init. At the GPT-3 init (std 0.02) a tiny model
    mostly repeats its last token, so a broken cache or block copy could
    still give the same tokens."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight")):
            a = rs.normal(0.0, 0.2, shape)
        elif len(shape) == 2:                      # paddle Linear: [in, out]
            a = rs.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        elif name.endswith("bias"):
            a = rs.normal(0.0, 0.1, shape)
        else:
            a = 1.0 + rs.normal(0.0, 0.1, shape)
        a = a.astype(np.float32)
        p.set_value(a)
        params[name] = a
    return params


@pytest.fixture(scope="module")
def pair():
    """A JAX GPT, its weights as numpy, and the port model carrying them."""
    paddle.seed(11)
    jm = JaxGPT(JaxGPTConfig(**SMALL))
    jm.eval()
    params = _spread_weights(jm, seed=11)
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    load_paddle_state(tm, params)
    tm.eval()
    return jm, params, tm


def test_convert_maps_every_name_and_round_trips(pair):
    _, params, tm = pair
    state = tm.state_dict()
    assert set(state) == set(params)            # tied head: no lm_head
    for name, arr in params.items():
        back = state[name].numpy()
        if name.endswith("_proj.weight") or name.endswith(("fc_in.weight",
                                                           "fc_out.weight")):
            back = back.T                       # torch [out, in] -> paddle
        np.testing.assert_array_equal(back, arr, err_msg=name)


@pytest.mark.parametrize("fault", ["leftover", "missing", "shape"])
def test_convert_refuses_unmapped_names_and_shapes(pair, fault):
    _, params, tm = pair
    bad = dict(params)
    if fault == "leftover":
        bad["lm_head.weight"] = params["gpt.wte.weight"].T
    elif fault == "missing":
        del bad["gpt.ln_f.bias"]
    else:
        bad["gpt.h.0.mlp.fc_in.weight"] = params["gpt.h.0.mlp.fc_in.weight"].T
    with pytest.raises(ValueError):
        convert_paddle_state(bad, tm)


def test_convert_casts_to_bf16():
    tm = GPTForCausalLM(GPTConfig(**dict(SMALL, num_layers=1)),
                        device="cpu", dtype="bfloat16")
    params = {}
    for name, t in tm.state_dict().items():
        a = t.float().numpy()
        params[name] = a.T if name.endswith(
            ("_proj.weight", "fc_in.weight", "fc_out.weight")) else a
    state = convert_paddle_state(params, tm)
    assert all(t.dtype == torch.bfloat16 for t in state.values())


def test_uncached_logits_match_jax(pair):
    jm, _, tm = pair
    ids = np.random.RandomState(0).randint(0, 256, (2, 160)).astype(np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    reset_launch_counts()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 160, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    # CPU tensors never reach a kernel launch
    assert launch_counts()["flash_pair_fwd"] == 0


def test_cached_forward_matches_uncached(pair):
    """The paged cached forward (two chunks through a block table) gives
    the uncached forward's hidden states at every position."""
    _, _, tm = pair
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 256, (1, 40))).long()
    bs, nblk = 8, 8
    pools = [(torch.zeros(nblk, bs, 2, 64), torch.zeros(nblk, bs, 2, 64))
             for _ in range(2)]
    table = torch.tensor([[3, 5, 1, 7, 2, 0, 0]])
    caches = [(pk, pv, table) for pk, pv in pools]
    with torch.no_grad():
        full = tm.gpt(ids)
        first = tm.gpt(ids[:, :24], kv_caches=caches, start_pos=0)
        # second chunk padded to 24 wide; writes past write_end go to trash
        pad = torch.cat([ids[:, 24:], torch.zeros(1, 8, dtype=torch.long)],
                        dim=1)
        second = tm.gpt(pad, kv_caches=caches, start_pos=24, write_end=40)
    got = torch.cat([first, second[:, :16]], dim=1)
    torch.testing.assert_close(got, full, atol=1e-5, rtol=1e-5)


def test_init_recipe():
    cfg = GPTConfig(**dict(SMALL, num_layers=4))
    tm = GPTForCausalLM(cfg, device="cpu", seed=3)
    sd = tm.state_dict()
    std = cfg.initializer_range
    resid = std / np.sqrt(2.0 * cfg.num_layers)
    assert abs(sd["gpt.wte.weight"].std().item() - std) < 0.1 * std
    assert abs(sd["gpt.h.0.mlp.fc_out.weight"].std().item() - resid) \
        < 0.1 * resid
    assert abs(sd["gpt.h.1.attn.out_proj.weight"].std().item() - resid) \
        < 0.1 * resid
    assert torch.count_nonzero(sd["gpt.h.0.attn.qkv_proj.bias"]) == 0
    assert torch.all(sd["gpt.h.0.ln_1.weight"] == 1.0)
    # the same seed gives the same weights
    again = GPTForCausalLM(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(GPTConfig(**SMALL))


def test_loss_with_labels_matches_jax(pair):
    """model(ids, labels) -> (None, loss), the shifted next-token CE with
    ignored labels, against the JAX model's (tests/test_torch_train.py
    holds its gradients and training steps)."""
    jm, _, tm = pair
    ids = np.random.RandomState(4).randint(0, 256, (2, 160)).astype(np.int32)
    labels = ids.copy()
    labels[:, :9] = -100
    _, ref = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    with torch.no_grad():
        none, got = tm(torch.from_numpy(ids).long(),
                       torch.from_numpy(labels).long())
    assert none is None
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_port_imports_no_jax_and_no_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.convert\n"
        "import paddle_tpu_torch.core, paddle_tpu_torch.kernels\n"
        "import paddle_tpu_torch.kernels._build\n"
        "import paddle_tpu_torch.nn.functional, paddle_tpu_torch.models\n"
        "import paddle_tpu_torch.serving, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.models.llama, paddle_tpu_torch.nn.norm\n"
        "import paddle_tpu_torch.kernels.flash_attention\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
