"""The port's goodput and MFU ledger (paddle_tpu_torch.monitor.goodput)
against the JAX package's, on the CPU.

* the interval ledger: the same interval lists (overlapping, out of
  order, folded, late) give the same per-state seconds, the same
  ``goodput/fraction`` and gauges that sum to ``goodput/wall_s``
  (exactly as in the JAX package: both sweep in Python floats);
* the FLOP ledger: the same counts and dispatches give the same MFU and
  HFU (the JAX side reads a fake executable's ``cost_analysis()``, the
  port a count's ``flops``), with the recompute split;
* the peak table: an H100 name resolves to 989e12 (the PCIe part to its
  own figure), ``PADDLE_PEAK_FLOPS`` wins, a TPU kind and an unknown card
  give None;
* the measured count: ``FlopCount`` counts a product as FlopCounterMode
  does, and the flash wrappers report their attention products (causal
  pairs only, forward 2 and backward 5 products), their plain versions
  running outside the count;
* ``TrainStep``'s analytic model equals the JAX package's on the same
  model, and the shared ``tools/goodput_report.py`` reads a port run.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import goodput as jgp
from paddle_tpu.monitor.registry import Registry as JaxRegistry
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import FlashAttention, FlashPairPacked
from paddle_tpu_torch.monitor import goodput as tgp
from paddle_tpu_torch.monitor.registry import Registry
from test_torch_accum_amp import SGD
from test_torch_train import SMALL, _batch, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _off(monkeypatch):
    monkeypatch.delenv("PADDLE_PEAK_FLOPS", raising=False)
    tmon.disable()
    yield
    tmon.disable()


def _ledgers(peak=None):
    return (jgp.GoodputLedger(JaxRegistry(), peak=peak),
            tgp.GoodputLedger(Registry(), peak=peak))


INTERVALS = {
    "overlap": [("productive", 1.0, 3.0), ("compile", 1.5, 2.5),
                ("ckpt_bg", 0.0, 4.0), ("data_wait", 0.2, 0.8),
                ("overhead", 3.0, 3.5)],
    "sync_ckpt": [("productive", 0.0, 2.0), ("ckpt", 1.0, 3.0)],
    "serving": [("overhead", 0.0, 1.0), ("productive", 0.1, 0.4),
                ("compile", 0.1, 0.3), ("productive", 0.5, 0.9),
                ("overhead", 1.2, 1.6), ("productive", 1.3, 1.35)],
}


@pytest.mark.parametrize("case", sorted(INTERVALS))
def test_interval_ledger_matches_jax(case):
    j, t = _ledgers()
    for led in (j, t):
        a = led._anchor
        for state, t0, t1 in INTERVALS[case]:
            led.add(state, a + t0, a + t1)
    vj = j.refresh(now=j._anchor + 5.0)
    vt = t.refresh(now=t._anchor + 5.0)
    assert vt == pytest.approx(vj, rel=1e-12, abs=1e-12)
    gj = j.registry.snapshot()["gauges"]
    gt = t.registry.snapshot()["gauges"]
    assert gt == pytest.approx(gj, rel=1e-12, abs=1e-12)
    total = sum(gt[f"goodput/{s}_s"] for s in tgp.GOODPUT_STATES)
    assert total == pytest.approx(gt["goodput/wall_s"], rel=1e-12)
    assert gt["goodput/fraction"] == gt["goodput/productive_s"] / total


def test_fold_and_late_claims_match_jax():
    """A forced fold, then late intervals reaching into the folded region:
    the same claims and clips in both."""
    j, t = _ledgers()
    for led in (j, t):
        a = led._anchor
        for i in range(0, 2 * tgp._FOLD_AT, 2):
            led.add("productive", a + i * 1e-3, a + (i + 1) * 1e-3)
        led.refresh(now=a + 1.2)
        led.add("ckpt_bg", a, a + 1.5)
        led.add("data_wait", a, a + 1.0)
    vj = j.refresh(now=j._anchor + 2.0)
    vt = t.refresh(now=t._anchor + 2.0)
    assert vt == pytest.approx(vj, rel=1e-12, abs=1e-12)
    assert tgp._FOLD_AT == jgp._FOLD_AT


class _FakeExe:
    """A JAX executable's cost analysis."""

    def __init__(self, flops):
        self.flops = flops

    def cost_analysis(self):
        return [{"flops": self.flops, "bytes accessed": 64.0}]


class _FakeCount:
    """The port's measured count (a ``FlopCount``'s surface)."""

    def __init__(self, flops):
        self.flops = flops


def test_flop_ledger_mfu_hfu_match_jax():
    j, t = _ledgers(peak=1e6)
    for led, make in ((j, _FakeExe), (t, _FakeCount)):
        a = led._anchor
        led.record_executable("train", 1, make(1000.0), tokens_per_call=10,
                              analytic_flops=800.0, recompute=True,
                              label="train_bucket1")
        led.dispatch("train", 1, a + 0.0, a + 0.1)
        led.record_executable("serve", ("decode", None), make(1000.0),
                              tokens_per_call=10, analytic_flops=900.0,
                              label="serve_decode")
        led.dispatch("serve", ("decode", None), a + 0.2, a + 0.3, tokens=4,
                     generated=True)
        led.dispatch("serve", ("decode", None), a + 0.3, a + 0.4, tokens=8)
        led.refresh(now=a + 1.0)
    gj = j.registry.snapshot()["gauges"]
    gt = t.registry.snapshot()["gauges"]
    keys = [k for k in gj if k.startswith(("mfu/", "serve/"))
            and not k.endswith("/bytes")]
    assert {k: gt[k] for k in keys} == pytest.approx(
        {k: gj[k] for k in keys}, rel=1e-12)
    assert gt["mfu/hfu"] > gt["mfu/mfu"]          # recompute split
    assert gt["mfu/model_flops"] == pytest.approx(800 + 400 + 800)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756e12), ("TPU v5 lite", None),
    ("TPU v4", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_table_knows_the_h100_only(name, peak):
    assert tgp.device_peak_flops(name) == peak
    assert not any(k.startswith("TPU") for k in tgp.PEAK_FLOPS)


def test_peak_env_override_wins(monkeypatch):
    monkeypatch.setenv("PADDLE_PEAK_FLOPS", "123e12")
    assert tgp.device_peak_flops("TPU v4") == 123e12
    assert tgp.device_peak_flops("NVIDIA H100 80GB HBM3") == 123e12
    monkeypatch.setenv("PADDLE_PEAK_FLOPS", "junk")
    assert tgp.device_peak_flops("NVIDIA H100 PCIe") == 756e12


def test_analytic_flops_per_token_is_the_jax_model():
    for args in ((354e6,), (354e6, 24, 1024, 1024), (1e3, 2, 64, 0)):
        assert tgp.analytic_train_flops_per_token(*args) == \
            jgp.analytic_train_flops_per_token(*args)


# ------------------------------------------------------------ measured count


def test_flop_count_counts_a_product():
    a, b = torch.randn(8, 32), torch.randn(32, 16)
    with tgp.FlopCount() as c:
        a @ b
    assert c.flops == 2 * 8 * 32 * 16 and c.kernel == 0
    assert not tgp.counting()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_pair_reports_its_attention_products(causal):
    """FlashPairPacked forward + backward on CPU tensors inside a count:
    the wrappers report 2 + 5 products over the (causal) pairs and their
    plain versions stay out of the count."""
    b, L, h, d = 2, 48, 2, 64
    qkv = torch.randn(b, L, 3 * h * d, requires_grad=True)
    with tgp.FlopCount() as c:
        FlashPairPacked.apply(qkv, h, causal).sum().backward()
    pairs = L * (L + 1) // 2 if causal else L * L
    want = (4.0 + 10.0) * b * h * pairs * d
    assert c.kernel == want and c.flops == want


def test_flash_attention_reports_the_visible_pairs():
    """The ``[B, L, H, D]`` wrappers with key lengths: the pairs the masks
    leave visible, counted from the data."""
    b, lq, h, hkv, d = 2, 40, 4, 2, 64
    q = torch.randn(b, lq, h, d, requires_grad=True)
    k = torch.randn(b, lq, hkv, d, requires_grad=True)
    v = torch.randn(b, lq, hkv, d, requires_grad=True)
    lens = torch.tensor([40, 17])
    with tgp.FlopCount() as c:
        FlashAttention.apply(q, k, v, True, 0.0, None, lens).sum().backward()
    rows = np.arange(lq)[:, None]
    cols = np.arange(lq)[None, :]
    pairs = sum(int(((cols <= rows) & (cols < n)).sum()) for n in (40, 17))
    assert c.kernel == (4.0 + 10.0) * h * pairs * d
    with tgp.FlopCount() as c2:
        FlashAttention.apply(q, k, v, False, 0.0, None, None)
    assert c2.kernel == 4.0 * b * h * lq * lq * d


def test_causal_pairs_bottom_right_aligned():
    assert tgp.causal_pairs(4, 4) == 10
    assert tgp.causal_pairs(2, 5) == 4 + 5      # rows see lk - lq + i + 1
    assert tgp.causal_pairs(1, 7) == 7


# ------------------------------------------------------------- integration


def test_train_step_ledger_with_a_peak(tmp_path, monkeypatch):
    """3 port steps with PADDLE_PEAK_FLOPS set: the measured and analytic
    FLOPs of the mint, MFU and HFU against that peak, the gauges summing to
    wall; the analytic count is the JAX package's formula over the same
    trainable parameters; tools/goodput_report.py reads the file."""
    monkeypatch.setenv("PADDLE_PEAK_FLOPS", "1e12")
    _, _, tm = _pair()
    ids, labels = _batch()
    path = str(tmp_path / "run.jsonl")
    tmon.enable(path)
    step = TrainStep(tm, SGD(learning_rate=0.1, parameters=tm.parameters()))
    for _ in range(3):
        step(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    g = tmon.snapshot()["gauges"]
    tmon.disable()
    n = sum(p.numel() for p in tm.parameters())
    tokens = ids.size
    assert g["mfu/train_bucket1/analytic_flops"] == \
        jgp.analytic_train_flops_per_token(
            n, SMALL["num_layers"], SMALL["hidden_size"], ids.shape[1]) \
        * tokens
    assert g["mfu/train_bucket1/flops"] > 0
    assert g["mfu/peak_flops"] == 1e12
    wall = g["goodput/wall_s"]
    assert g["mfu/hfu"] == pytest.approx(
        g["mfu/hw_flops"] / (wall * 1e12), rel=1e-6)
    assert g["mfu/hw_flops"] == pytest.approx(
        2 * g["mfu/train_bucket1/flops"])       # two dispatches billed
    total = sum(g[f"goodput/{s}_s"] for s in tgp.GOODPUT_STATES)
    assert total == pytest.approx(wall, rel=1e-9)
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "goodput_report.py"),
                          path], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
