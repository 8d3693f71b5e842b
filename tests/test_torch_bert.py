"""The port's BERT pretraining model (paddle_tpu_torch.models.bert) against
the JAX package's, on the same weights, in fp32 on the CPU.

The config's heads are 64 wide (hidden 128, 2 heads, FFN 256, 2 layers,
vocab 256, max_pos 128), so on the card attention would take the pair
kernels, and the width is a multiple of 128, so the residual epilogues
take the fused add-dropout-LayerNorm (its plain version here). At dropout
0 the port is held to the JAX model: MLM/NSP logits, the pretraining loss,
every leaf's gradient and 3 AdamW TrainSteps, on the packed path and on
padded batches (``seq_lens``, or an additive ``attn_mask``: the JAX
package's other branch, sdpa with ``kv_lens``). At dropout 0.1 the two
packages draw different bits, so the port is held to its own contract:
the same generator seed gives the same loss, training differs from eval,
and a padded batch at full lengths gives the packed path's loss. Weights
are drawn with numpy and carried by convert.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPreTraining as JaxBert
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                     BertModel, bert_base, bert_tiny)
from paddle_tpu_torch.optimizer import AdamW

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position_embeddings=128,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
B, S = 2, 128


def _weights(jm, seed):
    """Numpy weights at a scale where attention matters (matrices ~ N(0,
    1/fan_in), embeddings ~ N(0, 0.2^2), LayerNorm near its init), set on
    the JAX model and returned for the port."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if "embeddings" in name and name.endswith("weight") \
                and len(shape) == 2:
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


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, SMALL["vocab_size"], (B, S)).astype(np.int32)
    types = (np.arange(S)[None, :] >= np.array([[40], [90]])).astype(np.int32)
    mlm = np.where(rs.rand(B, S) < 0.15, ids, -100).astype(np.int32)
    nsp = np.array([0, 1], np.int32)
    return ids, types, mlm, nsp


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def _j(*arrays):
    return [paddle.to_tensor(a) for a in arrays]


def _pair(seed=5, **overrides):
    paddle.seed(seed)
    jm = JaxBert(JaxBertConfig(**dict(SMALL, **overrides)))
    params = _weights(jm, seed)
    tm = BertForPreTraining(BertConfig(**dict(SMALL, **overrides)),
                            device="cpu")
    load_paddle_state(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_logits_match_jax(pair):
    """Eval, no labels: (mlm_logits [B, S, V], nsp_logits [B, 2])."""
    jm, _, tm = pair
    jm.eval()
    tm.eval()
    ids, types, _, _ = _batch()
    mlm_j, nsp_j = jm(*_j(ids, types))
    with torch.no_grad():
        mlm_t, nsp_t = tm(*_t(ids, types))
    assert mlm_t.shape == (B, S, SMALL["vocab_size"]) and nsp_t.shape == (B, 2)
    np.testing.assert_allclose(mlm_t.numpy(), np.asarray(mlm_j.numpy()),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(nsp_t.numpy(), np.asarray(nsp_j.numpy()),
                               atol=1e-4, rtol=1e-4)


def test_loss_and_every_leaf_gradient_match_jax():
    """Training mode at dropout 0 with MLM and NSP labels: the loss (MLM
    head + CE over every position with the decoder bias, plus NSP CE)
    within 1e-5, and every leaf's gradient within 1e-4, mapped to the
    port's layout as the weights are (the tied word embeddings get both the
    lookup and the head terms).

    The JAX gradients come from one compiled step of SGD at learning rate
    1 (gradient = weight before - weight after): the JAX package's eager
    tape loses the qkv projections' gradients on the CPU (its
    ``flash_attention_qkv_packed`` fallback re-wraps the unwrapped qkv
    array), its compiled step does not."""
    jm, _, tm = _pair(seed=9)
    jm.train()
    tm.train()
    batch = _batch(1)
    loss_j = float(jm(*_j(*batch[:2]), None, *_j(*batch[2:])))
    before = {n: np.asarray(p.numpy(), np.float32).copy()
              for n, p in jm.named_parameters()}
    sgd = paddle.optimizer.SGD(learning_rate=1.0, parameters=jm.parameters())
    assert float(paddle.jit.TrainStep(_JaxLossOf(jm), sgd)(
        *_j(*batch))) == pytest.approx(loss_j, rel=1e-6)
    grads_j = {n: before[n] - np.asarray(p.numpy(), np.float32)
               for n, p in jm.named_parameters()}
    ids, types, mlm, nsp = _t(*batch)
    loss_t = tm(ids, types, None, mlm, nsp)
    assert loss_t.dim() == 0 and loss_t.dtype == torch.float32
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=1e-5)
    loss_t.backward()
    want = convert_paddle_state(grads_j, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


class _JaxLossOf(paddle.nn.Layer):
    """(ids, types, mlm, nsp) -> the JAX model's loss (TrainStep inputs are
    arrays; attn_mask stays None)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, types, mlm, nsp):
        return self.model(ids, types, None, mlm, nsp)


def test_three_train_steps_match_jax():
    """3 TrainStep + AdamW(1e-3, wd 0.01) calls on a repeated batch: every
    step's loss within 1e-4 relative of the JAX package's, and every
    parameter after step 3 within 1e-4 wherever its first gradient is live
    (above 1e-5 of its leaf's largest; below that Adam turns fp32 noise
    into steps of +-lr in either package)."""
    jm, _, tm = _pair(seed=6)
    jm.train()
    tm.train()
    batch = _batch(2)
    opt_j = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                   parameters=jm.parameters())
    step_j = paddle.jit.TrainStep(_JaxLossOf(jm), opt_j)
    opt_t = AdamW(learning_rate=1e-3, weight_decay=0.01,
                  parameters=tm.parameters())
    step_t = TrainStep(tm, opt_t)
    first = {}

    def keep_first(name):
        def hook(grad):
            first.setdefault(name, grad.abs())
        return hook

    hooks = [p.register_hook(keep_first(n)) for n, p in tm.named_parameters()]
    ids, types, mlm, nsp = _t(*batch)
    losses_j, losses_t = [], []
    for _ in range(3):
        losses_j.append(float(step_j(*_j(*batch))))
        losses_t.append(step_t(ids, types, None, mlm, nsp).item())
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[2] < losses_t[0]
    want = convert_paddle_state(
        {n: np.asarray(p.numpy(), np.float32)
         for n, p in jm.named_parameters()}, tm)
    for name, p in tm.named_parameters():
        diff = (p.detach() - want[name]).abs()
        live = first[name] > 1e-5 * first[name].max()
        assert float(diff[live].max()) < 1e-4, name


def test_dropout_is_deterministic_per_generator_seed():
    """At dropout 0.1 (embeddings, attention, both residuals): the same
    generator seed gives the same loss and gradients, another seed another
    loss, and training differs from eval; nothing launches on the CPU."""
    _, _, tm = _pair(seed=7, hidden_dropout_prob=0.1,
                     attention_dropout_prob=0.1)
    ids, types, mlm, nsp = _t(*_batch(3))
    tm.train()
    reset_launch_counts()
    losses, grads = [], []
    for s in (11, 11, 12):
        tm.zero_grad(set_to_none=True)
        tm.generator.manual_seed(s)
        loss = tm(ids, types, None, mlm, nsp)
        loss.backward()
        losses.append(loss.item())
        grads.append(tm.bert.encoder[0].qkv_proj.weight.grad.clone())
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert torch.equal(grads[0], grads[1])
    assert all(v == 0 for v in launch_counts().values())
    tm.eval()
    with torch.no_grad():
        eval_loss = tm(ids, types, None, mlm, nsp).item()
    assert eval_loss != losses[0]


def test_convert_round_trips_bert():
    """convert.py maps the JAX package's BERT names one to one: Linear
    weights transposed, the tied word embeddings (an nn.Embedding) and the
    bare decoder_bias as they are."""
    jm, params, tm = _pair(seed=8)
    state = tm.state_dict()
    for name, arr in params.items():
        got = state[name].numpy()
        if name.endswith("weight") and isinstance(
                tm.get_submodule(name.rsplit(".", 1)[0]), torch.nn.Linear):
            got = got.T
        np.testing.assert_array_equal(got, arr, err_msg=name)
    assert "decoder_bias" in params
    assert state["bert.embeddings.word_embeddings.weight"].shape == (
        SMALL["vocab_size"], SMALL["hidden_size"])


def test_padded_route_and_missing_generator_raise():
    """The padded route runs (it raised before it was ported): seq_lens
    and the equivalent additive attn_mask give one output, which differs
    from the unpadded batch's, and full lengths give the packed path's.
    Dropout in training without a generator still raises, on both
    routes."""
    tm = BertForPreTraining(BertConfig(**SMALL), device="cpu").eval()
    ids = torch.randint(0, SMALL["vocab_size"], (2, 8),
                        generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([8, 5])
    with torch.no_grad():
        by_lens = tm(ids, seq_lens=lens)[0]
        by_mask = tm(ids, attn_mask=_additive(lens, 8))[0]
        packed = tm(ids)[0]
        full = tm(ids, seq_lens=torch.tensor([8, 8]))[0]
    torch.testing.assert_close(by_lens, by_mask)
    torch.testing.assert_close(full, packed, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(by_lens, packed, atol=1e-3)
    bare = BertModel(BertConfig(**dict(SMALL, hidden_dropout_prob=0.1)))
    with pytest.raises(ValueError, match="generator"):
        bare(ids)
    bare = BertModel(BertConfig(**dict(SMALL, attention_dropout_prob=0.1)))
    with pytest.raises(ValueError, match="generator"):
        bare(ids, seq_lens=lens)


def _additive(lens, s):
    """The [B, 1, 1, S] additive padding mask of lengths ``lens``: 0 on
    valid keys, -1e30 past them (numpy in, numpy out; torch in, torch
    out)."""
    lens_np = np.asarray(lens)
    mask = np.where(np.arange(s)[None, :] < lens_np[:, None], 0.0,
                    -1e30).astype(np.float32)[:, None, None, :]
    return torch.from_numpy(mask) if torch.is_tensor(lens) else mask


def _padded_batch(seed, lens, s=S):
    """A padded pretraining batch (numpy): ids and token types 0 past each
    length, MLM labels on 15% of the valid positions (-100 elsewhere),
    NSP labels."""
    rs = np.random.RandomState(seed)
    b = len(lens)
    valid = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    ids = np.where(valid, rs.randint(1, SMALL["vocab_size"], (b, s)),
                   0).astype(np.int32)
    types = ((np.arange(s)[None, :] >= np.asarray(lens)[:, None] // 2)
             & valid).astype(np.int32)
    mlm = np.where(valid & (rs.rand(b, s) < 0.15), ids, -100) \
        .astype(np.int32)
    nsp = rs.randint(0, 2, (b,)).astype(np.int32)
    return ids, types, mlm, nsp


PAD_LENS = [128, 53]


def _route_inputs(route, lens):
    """The masks of a padded route as (attn_mask, seq_lens) for the JAX
    model and for the port: ``seq_lens`` or an additive ``attn_mask``."""
    if route == "seq_lens":
        arr = np.asarray(lens, np.int32)
        return (None, paddle.to_tensor(arr)), (None, torch.from_numpy(arr))
    mask = _additive(lens, S)
    return (paddle.to_tensor(mask), None), (torch.from_numpy(mask), None)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("route", ["seq_lens", "attn_mask"])
def test_padded_logits_loss_and_gradients_match_jax(route):
    """A padded batch (lengths 128 and 53) at dropout 0: eval logits, the
    training loss and every leaf's gradient within 1e-5 relative of the JAX
    model on the same weights. The JAX gradients come from its eager
    ``loss.backward()``: on the padded branch its tape holds (the packed
    branch's loses qkv_proj on the CPU)."""
    jm, _, tm = _pair(seed=10)
    (jmask, jlens), (tmask, tlens) = _route_inputs(route, PAD_LENS)
    ids, types, mlm, nsp = _padded_batch(4, PAD_LENS)
    jm.eval()
    tm.eval()
    mlm_j, nsp_j = jm(*_j(ids, types), jmask, None, None, jlens)
    with torch.no_grad():
        mlm_t, nsp_t = tm(*_t(ids, types), tmask, None, None, tlens)
    assert _rel(mlm_t.numpy(), mlm_j.numpy()) < 1e-5
    assert _rel(nsp_t.numpy(), nsp_j.numpy()) < 1e-5
    jm.train()
    tm.train()
    loss_j = jm(*_j(ids, types), jmask, *_j(mlm, nsp), jlens)
    loss_j.backward()
    loss_t = tm(*_t(ids, types), tmask, *_t(mlm, nsp), tlens)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = convert_paddle_state(
        {n: np.asarray(p.grad.numpy(), np.float32)
         for n, p in jm.named_parameters()}, tm)
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) < 1e-5, name


class _JaxPaddedLossOf(paddle.nn.Layer):
    """(ids, types, mlm, nsp, mask) -> the JAX model's loss on a padded
    batch, the mask as ``seq_lens`` or ``attn_mask``."""

    def __init__(self, model, route):
        super().__init__()
        self.model, self.route = model, route

    def forward(self, ids, types, mlm, nsp, mask):
        if self.route == "seq_lens":
            return self.model(ids, types, None, mlm, nsp, mask)
        return self.model(ids, types, mask, mlm, nsp)


@pytest.mark.parametrize("route", ["seq_lens", "attn_mask"])
def test_padded_three_train_steps_match_jax(route):
    """3 TrainStep + AdamW(1e-3, wd 0.01) calls on a repeated padded batch:
    every step's loss within 1e-4 relative of the JAX package's, and the
    loss falls."""
    jm, _, tm = _pair(seed=11)
    jm.train()
    tm.train()
    (jmask, jlens), (tmask, tlens) = _route_inputs(route, PAD_LENS)
    ids, types, mlm, nsp = _padded_batch(5, PAD_LENS)
    step_j = paddle.jit.TrainStep(
        _JaxPaddedLossOf(jm, route),
        paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=jm.parameters()))
    step_t = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=tm.parameters()))
    losses_j, losses_t = [], []
    for _ in range(3):
        losses_j.append(float(step_j(*_j(ids, types, mlm, nsp),
                                     jlens if jmask is None else jmask)))
        losses_t.append(step_t(*_t(ids, types), tmask, *_t(mlm, nsp),
                               tlens).item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[2] < losses_t[0]


def test_padded_dropout_is_deterministic_and_full_lengths_equal_packed():
    """At dropout 0.1 on the padded route: the same generator seed gives
    the same loss and gradients, another seed another loss; with every
    length = S the padded route draws the packed path's seeds in the same
    order and drops the same attention pairs, so loss and gradients equal
    the packed path's (fp32, 1e-5 relative)."""
    _, _, tm = _pair(seed=12, hidden_dropout_prob=0.1,
                     attention_dropout_prob=0.1)
    tm.train()
    ids, types, mlm, nsp = _t(*_padded_batch(6, PAD_LENS))

    def run(gen_seed, lens=None):
        tm.zero_grad(set_to_none=True)
        tm.generator.manual_seed(gen_seed)
        loss = tm(ids, types, None, mlm, nsp, lens)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in tm.named_parameters()}

    lens = torch.tensor(PAD_LENS)
    a, ga = run(21, lens)
    b, gb = run(21, lens)
    c, _ = run(22, lens)
    assert a == b and a != c
    assert all(torch.equal(ga[n], gb[n]) for n in ga)
    full, g_full = run(23, torch.tensor([S, S]))
    packed, g_packed = run(23)
    assert abs(full - packed) <= 1e-5 * abs(packed)
    for n in g_full:
        assert _rel(g_full[n].numpy(), g_packed[n].numpy()) < 1e-5, n


def test_configs():
    base = bert_base()
    assert (base.vocab_size, base.hidden_size, base.num_layers,
            base.num_heads, base.intermediate_size) == (30528, 768, 12, 12,
                                                        3072)
    assert base.hidden_dropout_prob == base.attention_dropout_prob == 0.1
    assert base.layer_norm_epsilon == 1e-12
    assert bert_tiny().hidden_size == 64


@pytest.mark.cuda
def test_cuda_bert_step_goes_through_the_kernels():
    """One training step of a 2-layer BERT-base-width model on the card:
    the pair kernels, the fused-LN kernels and the dropout kernel launch
    the counts of the path, and the loss and gradients agree with the CPU
    plain path from the same weights and generator state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = bert_base(num_layers=2)
    cpu = BertForPreTraining(cfg, device="cpu", seed=3)
    card = BertForPreTraining(cfg, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(4)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 256))).long()
    mlm = torch.where(torch.from_numpy(rs.rand(2, 256)) < 0.15, ids, -100)
    nsp = torch.tensor([1, 0])
    reset_launch_counts()
    loss_card = card(ids.cuda(), None, None, mlm.cuda(), nsp.cuda())
    loss_card.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_pair_fwd"] == 2 and counts["flash_pair_bwd"] == 2
    assert counts["fused_add_dropout_ln_fwd"] == 4
    assert counts["fused_add_dropout_ln_bwd"] == 4
    assert counts["dropout_fwd"] == 2
    loss_cpu = cpu(ids, None, None, mlm, nsp)
    loss_cpu.backward()
    assert abs(loss_card.item() - loss_cpu.item()) < 1e-4 * loss_cpu.item()
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        if b.grad is None:
            continue
        rel = ((a.grad.cpu() - b.grad).norm() / b.grad.norm()).item()
        assert rel < 1e-4, name


@pytest.mark.cuda
def test_cuda_padded_bert_step_goes_through_the_flat_kernels():
    """One training step of a 2-layer BERT-base-width model on a padded
    batch (seq_lens) at dropout 0.1 on the card: the flat flash kernels
    (not the pair kernels), the fused-LN kernels and the dropout kernel
    launch the counts of the path, and the loss and every leaf's gradient
    agree with the CPU plain path from the same weights and generator
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = bert_base(num_layers=2)
    cpu = BertForPreTraining(cfg, device="cpu", seed=3)
    card = BertForPreTraining(cfg, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(5)
    lens = torch.tensor([256, 130])
    valid = torch.arange(256)[None, :] < lens[:, None]
    ids = torch.where(valid, torch.from_numpy(
        rs.randint(1, cfg.vocab_size, (2, 256))).long(), 0)
    mlm = torch.where(valid & (torch.from_numpy(rs.rand(2, 256)) < 0.15),
                      ids, -100)
    nsp = torch.tensor([1, 0])
    reset_launch_counts()
    loss_card = card(ids.cuda(), None, None, mlm.cuda(), nsp.cuda(),
                     seq_lens=lens.cuda())
    loss_card.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 2
    assert counts["flash_attention_bwd"] == 2
    assert counts["flash_pair_fwd"] == counts["flash_pair_bwd"] == 0
    assert counts["fused_add_dropout_ln_fwd"] == 4
    assert counts["fused_add_dropout_ln_bwd"] == 4
    assert counts["dropout_fwd"] == 2
    loss_cpu = cpu(ids, None, None, mlm, nsp, seq_lens=lens)
    loss_cpu.backward()
    assert abs(loss_card.item() - loss_cpu.item()) < 1e-4 * loss_cpu.item()
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        if b.grad is None:
            continue
        rel = ((a.grad.cpu() - b.grad).norm() / b.grad.norm()).item()
        assert rel < 1e-4, name


def test_init_matches_the_reference_per_parameter():
    """The init's spread per parameter against the JAX package's (the two
    draw different numbers, so the test is statistical): BertModel's
    matrices N(0, 0.02), the heads' ``transform`` and ``nsp_head`` weights
    nn.Linear's default XavierUniform (std sqrt(2 / (fan_in + fan_out)):
    0.036 and 0.051 at BERT-base's width, 0.0625 and 0.088 here), biases
    0 and LayerNorm 1 in both. Each matrix's std agrees within 15% (the
    smallest, nsp_head's 512 values, estimates its std within ~3%)."""
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=1, num_heads=4,
               intermediate_size=512, max_position_embeddings=128)
    paddle.seed(0)
    jm = JaxBert(JaxBertConfig(**cfg))
    tm = BertForPreTraining(BertConfig(**cfg), device="cpu", seed=0)
    jstd = {n: float(np.asarray(p.numpy()).std())
            for n, p in jm.named_parameters()}
    tparams = dict(tm.named_parameters())
    assert set(jstd) == set(tparams)
    for name, p in tparams.items():
        got = float(p.detach().double().std(unbiased=False))
        if p.ndim >= 2:
            assert abs(got / jstd[name] - 1.0) < 0.15, (name, got,
                                                         jstd[name])
        else:
            assert got == pytest.approx(jstd[name], abs=1e-7), name
    h = cfg["hidden_size"]
    for name, fan_out in (("transform.weight", h), ("nsp_head.weight", 2)):
        want = (2.0 / (h + fan_out)) ** 0.5
        got = float(tparams[name].detach().std())
        assert abs(got / want - 1.0) < 0.1, (name, got, want)
    assert abs(float(tparams["bert.pooler.weight"].detach().std()) / 0.02
               - 1.0) < 0.05
