"""The port's hapi (``paddle_tpu_torch.Model``, ``callbacks``,
``hapi.async_metrics``), ``fleet.GradientMergeOptimizer`` and the F12
repair against the JAX package on the CPU, fp32.

One tiny conv net (``Conv2D(3, 4, 3)``, ``BatchNorm2D``, ReLU, max pool,
``Linear(64, 3)``) is built by the JAX package from a seed and its state
carried into the port's (``convert.load_paddle_layer_state``); both train
on the same seeded ``io.TensorDataset`` of ``[3, 8, 8]`` images with the
same numpy seed for the shuffle.

Tolerances. Against the JAX package: every step's loss within LOSS_TOL
(1e-5, relative) and its accuracy equal; parameters and buffers after
training within STATE_TOL (1e-5, norm-relative a tensor; the two
packages' fp32 convolutions sum in different orders). The port against
itself (``metric_lag``, a ``DeviceLoader``, resume after SIGTERM, the
compiled routes against each other): bit for bit. F12: the batch norm's
running buffers after one ``TrainStep`` under recompute within 1e-6 of
the JAX ``TrainStep``'s, and bit for bit the port's own run without
recompute."""
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu  # noqa: F401
from paddle_tpu.distributed.fleet.meta_optimizer_wrappers import \
    GradientMergeOptimizer as JaxGradientMerge
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.distributed.fleet import GradientMergeOptimizer

LOSS_TOL = 1e-5
STATE_TOL = 1e-5
BN_TOL = 1e-6
N, BATCH = 48, 8


def _net(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.MaxPool2D(2), nn.Flatten(),
                         nn.Linear(64, 3))


def _data(n=N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 3, 8, 8)).astype(np.float32),
            r.integers(0, 3, (n,)).astype(np.int64))


def _pair(seed=0):
    """The JAX net from ``seed`` and the port's with its state."""
    jp.seed(seed)
    j = _net(jp)
    t = _net(tp)
    load_paddle_layer_state(t, {k: np.asarray(v.numpy())
                                for k, v in j.state_dict().items()})
    return j, t


def _state(pkg_model):
    return {k: np.asarray(v.numpy()) for k, v in
            pkg_model.state_dict().items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hold_states(got, want, tol=STATE_TOL):
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < tol, k


def _bits(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _recorder(pkg):
    class Rec(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.logs = []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))
    return Rec()


def _fit(pkg, net, data, opt=None, metrics=None, seed=3, epochs=1, **kw):
    """``pkg.Model(net).fit`` on ``data`` (shuffled under numpy seed
    ``seed``): the per-step logs and the Model."""
    prep = kw.pop("prepare", {})
    model = pkg.Model(net)
    model.prepare(opt or pkg.optimizer.Momentum(
        0.1, 0.9, parameters=net.parameters()), pkg.nn.CrossEntropyLoss(),
        metrics, **prep)
    rec = _recorder(pkg)
    np.random.seed(seed)
    model.fit(data, batch_size=kw.pop("batch_size", BATCH), epochs=epochs,
              shuffle=kw.pop("shuffle", True), verbose=0,
              callbacks=[rec] + kw.pop("callbacks", []), **kw)
    return rec.logs, model


def _hold_logs(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL * max(1, abs(w["loss"]))
        for k in w:
            if k != "loss":
                assert g[k] == w[k], (k, g, w)


# ------------------------------------------------------------------ F12

class _RecomputeNet:
    """``Conv2D(3, 3, 3, padding=1)`` + ``BatchNorm2D(3)``, the pair under
    ``fleet.recompute`` or not; the loss is the output's mean square."""

    @staticmethod
    def build(pkg, recompute):
        class Net(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.conv = pkg.nn.Conv2D(3, 3, 3, padding=1)
                self.bn = pkg.nn.BatchNorm2D(3)

            def forward(self, x):
                def block(t):
                    return self.bn(self.conv(t))
                y = pkg.distributed.fleet.recompute(block, x) if recompute \
                    else block(x)
                return (y * y).mean()
        return Net()


@pytest.mark.parametrize("fast_path", [False, True])
def test_recompute_updates_batch_norm_statistics_once(fast_path):
    """F12: one ``TrainStep`` with ``SGD(lr=0)`` on a seeded [4, 3, 5, 5]
    batch: the port's ``_mean`` / ``_variance`` under recompute within
    BN_TOL of the JAX ``TrainStep``'s, and bit for bit the port's own run
    without recompute (the replay leaves the buffers as they are)."""
    x = np.random.default_rng(0).standard_normal((4, 3, 5, 5)) \
        .astype(np.float32)
    jp.seed(0)
    j = _RecomputeNet.build(jp, True)
    init = _state(j)
    jp.jit.TrainStep(j, jp.optimizer.SGD(0.0, parameters=j.parameters()))(
        jp.to_tensor(x))
    want = {k: v for k, v in _state(j).items() if "bn._" in k}
    got = {}
    for recompute in (True, False):
        t = _RecomputeNet.build(tp, recompute)
        load_paddle_layer_state(t, init)
        step = tp.jit.TrainStep(
            t, tp.optimizer.SGD(0.0, parameters=t.parameters()),
            fast_path=fast_path)
        step(tp.to_tensor(x))
        got[recompute] = {k: v for k, v in _state(t).items() if "bn._" in k}
    for k, w in want.items():
        assert np.abs(got[True][k] - w).max() < BN_TOL, k
        assert not np.array_equal(w, init[k]), k
    _bits(got[True], got[False])


def test_recompute_replay_flag_is_scoped():
    """The replay flag is set only inside a recompute region's replay: an
    eager ``backward()`` under recompute moves the buffers once, and the
    flag is off after it."""
    from paddle_tpu_torch.core import remat
    x = tp.to_tensor(np.random.default_rng(1).standard_normal(
        (4, 3, 5, 5)).astype(np.float32))
    once = _RecomputeNet.build(tp, False)
    twice = _RecomputeNet.build(tp, True)
    twice.set_state_dict(once.state_dict())
    for net in (once, twice):
        net(x).backward()
    assert not remat.in_replay()
    _bits(_state(twice), _state(once))


# ------------------------------------------------------------ Model.fit

def test_fit_eager_matches_jax():
    """Eager ``Model.fit`` with ``Momentum`` and ``Accuracy``, 2 epochs of
    6 shuffled batches: every step's loss and accuracy as the JAX
    ``Model.fit``'s, and the state after it."""
    j, t = _pair()
    data = _data()
    want, _ = _fit(jp, j, jp.io.TensorDataset(list(data)),
                   metrics=jp.metric.Accuracy(), epochs=2)
    got, _ = _fit(tp, t, tp.io.TensorDataset(list(data)),
                  metrics=tp.metric.Accuracy(), epochs=2)
    _hold_logs(got, want)
    _hold_states(_state(t), _state(j))


@pytest.mark.parametrize("prepare", [dict(jit_compile=True),
                                     dict(accumulate_steps=2)],
                         ids=["jit_compile", "accumulate_steps"])
def test_fit_compiled_matches_jax(prepare):
    """``prepare(jit_compile=True)`` and ``prepare(accumulate_steps=2)``:
    the port's ``TrainStep`` (its program run eagerly on the CPU) against
    the JAX ``Model`` with the same ``prepare``."""
    j, t = _pair()
    data = _data()
    want, jm = _fit(jp, j, jp.io.TensorDataset(list(data)), prepare=prepare)
    got, tm = _fit(tp, t, tp.io.TensorDataset(list(data)), prepare=prepare)
    _hold_logs(got, want)
    _hold_states(_state(t), _state(j))
    assert tm._train_step.num_compiles == 1
    if "accumulate_steps" in prepare:
        assert len(got) == N // BATCH // 2


def test_fit_metric_lag_and_device_loader_are_the_same_run():
    """``fit(metric_lag=2)`` and a ``DeviceLoader(device="cpu")`` over the
    same ``DataLoader``: the logs and the state bit for bit the synced
    run's."""
    data = _data()
    runs = []
    for kind in ("sync", "lag", "device"):
        _, t = _pair()
        loader = tp.io.DataLoader(tp.io.TensorDataset(list(data)),
                                  batch_size=BATCH, shuffle=True)
        if kind == "device":
            loader = tp.io.DeviceLoader(loader, device="cpu")
        logs, _ = _fit(tp, t, loader, prepare=dict(jit_compile=True),
                       metric_lag=2 if kind == "lag" else 0)
        runs.append((logs, _state(t)))
    for logs, state in runs[1:]:
        assert logs == runs[0][0]
        _bits(state, runs[0][1])


def test_train_batch_update_false_buffers_an_accumulation_window():
    """``prepare(accumulate_steps=2)``: ``train_batch(update=False)`` then
    ``update=True`` is one window, bit for bit the stacked call's."""
    x, y = _data(16)
    states = []
    for stacked in (False, True):
        _, t = _pair()
        m = tp.Model(t)
        m.prepare(tp.optimizer.SGD(0.1, parameters=t.parameters()),
                  tp.nn.CrossEntropyLoss(), accumulate_steps=2)
        if stacked:
            loss = m.train_batch([np.stack([x[:8], x[8:]])],
                                 [np.stack([y[:8], y[8:]])])
        else:
            assert m.train_batch([x[:8]], [y[:8]], update=False) is None
            loss = m.train_batch([x[8:]], [y[8:]])
        states.append((loss, _state(t)))
    assert states[0][0] == states[1][0]
    _bits(states[0][1], states[1][1])
    with pytest.raises(ValueError, match="stacked with leading axis 2"):
        m.train_batch([x[:8]], [y[:8]])


def test_evaluate_and_predict_match_jax():
    """``evaluate`` with ``Accuracy(topk=(1, 2))`` and
    ``predict(stack_outputs=True)`` on the carried state: the JAX values
    (logits within LOSS_TOL)."""
    j, t = _pair()
    x, y = _data(20, seed=1)
    out = {}
    for pkg, net in ((jp, j), (tp, t)):
        m = pkg.Model(net)
        m.prepare(loss=pkg.nn.CrossEntropyLoss(),
                  metrics=pkg.metric.Accuracy(topk=(1, 2)))
        logs = m.evaluate(pkg.io.TensorDataset([x, y]), batch_size=8,
                          verbose=0)
        pred = m.predict(pkg.io.TensorDataset([x]), batch_size=8,
                         stack_outputs=True)
        out[pkg] = (logs, pred)
    (jl, jpred), (tl, tpred) = out[jp], out[tp]
    assert tpred.shape == jpred.shape == (20, 3)
    assert _rel(tpred, jpred) < LOSS_TOL
    assert tl["acc"] == jl["acc"]
    assert abs(tl["loss"] - jl["loss"]) < LOSS_TOL * abs(jl["loss"])
    # the hand forward, bit for bit
    with tp.no_grad():
        t.eval()
        hand = t(tp.to_tensor(x)).numpy()
    np.testing.assert_array_equal(tpred, hand)


def test_predict_multi_output_and_summary():
    class Two(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(4, 2)

        def forward(self, x):
            y = self.fc(x)
            return y, y * 2
    m = tp.Model(Two())
    x = np.ones((6, 4), np.float32)
    a, b = m.predict(tp.io.TensorDataset([x]), batch_size=4,
                     stack_outputs=True)
    np.testing.assert_array_equal(b, a * 2)
    assert a.shape == (6, 2)
    assert m.summary() == {"total_params": 10, "trainable_params": 10}


# ------------------------------------------------------------ callbacks

def test_early_stopping_and_lr_scheduler_match_jax():
    """``EarlyStopping(patience=1)`` at lr 0 stops as the JAX run does;
    ``LRScheduler`` steps a ``StepDecay`` once a batch in both."""
    hist = {}
    for pkg in (jp, tp):
        pkg.seed(1)
        net = _net(pkg)
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(0.0, parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss())
        es = pkg.callbacks.EarlyStopping(monitor="loss", patience=1,
                                         verbose=0, save_best_model=False)
        x, y = _data(16)
        hist[pkg] = m.fit(pkg.io.TensorDataset([x, y]),
                          pkg.io.TensorDataset([x, y]), batch_size=8,
                          epochs=6, verbose=0, shuffle=False, callbacks=[es])
        assert m.stop_training
    assert len(hist[tp]) == len(hist[jp]) < 6
    lrs = {}
    for pkg in (jp, tp):
        net = _net(pkg)
        sched = pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                           gamma=0.5)
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(sched, parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss())
        m.fit(pkg.io.TensorDataset(list(_data(40))), batch_size=8, epochs=1,
              verbose=0, callbacks=[pkg.callbacks.LRScheduler()])
        lrs[pkg] = sched.last_lr
    assert lrs[tp] == lrs[jp] == pytest.approx(0.025)


def test_model_checkpoint_and_save_load_round_trip(tmp_path):
    """``ModelCheckpoint`` writes a snapshot an epoch and ``final``; a
    fresh Model ``load``s one back bit for bit (parameters, buffers and the
    optimizer's velocities and step count); ``save(training=False)``
    raises, naming ROADMAP item 11."""
    _, t = _pair()
    logs, m = _fit(tp, t, tp.io.TensorDataset(list(_data())), epochs=2,
                   save_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    _, t2 = _pair(seed=5)
    m2 = tp.Model(t2)
    opt2 = tp.optimizer.Momentum(0.1, 0.9, parameters=t2.parameters())
    m2.prepare(opt2, tp.nn.CrossEntropyLoss())
    m2.load(str(tmp_path / "final"))
    _bits(_state(t2), _state(t))
    assert opt2._step_count == m._optimizer._step_count == len(logs)
    for p, q in zip(opt2._parameter_list, m._optimizer._parameter_list):
        torch.testing.assert_close(
            opt2._accumulators[id(p)]["velocity"],
            m._optimizer._accumulators[id(q)]["velocity"], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="item 11"):
        m.save(str(tmp_path / "infer"), training=False)


class _SigtermAt(tp.callbacks.Callback):
    """Sends this process SIGTERM at the end of global batch ``at``."""

    def __init__(self, at):
        super().__init__()
        self.at, self.n = at, 0

    def on_train_batch_end(self, step, logs=None):
        self.n += 1
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)


@pytest.mark.parametrize("prepare", [{}, dict(jit_compile=True)],
                         ids=["eager", "jit_compile"])
def test_auto_checkpoint_sigterm_then_resume_is_bit_exact(tmp_path,
                                                          prepare):
    """``AutoCheckpoint(save_steps=2)``: SIGTERM after batch 5 takes an
    emergency snapshot at step 5 and stops the fit; a second fit resumes
    from it (replaying the data position) and ends with the parameters,
    buffers, velocities and step count of an uninterrupted run, bit for
    bit. The SIGTERM handler is the one before, after each fit."""
    data = tp.io.TensorDataset(list(_data()))
    prev = signal.getsignal(signal.SIGTERM)

    def run(cbs, directory=None):
        _, t = _pair()
        ck = [] if directory is None else [tp.callbacks.AutoCheckpoint(
            str(directory), save_steps=2, asynchronous=False, verbose=0)]
        logs, m = _fit(tp, t, data, prepare=dict(prepare), epochs=2,
                       callbacks=cbs + ck)
        assert signal.getsignal(signal.SIGTERM) == prev
        return logs, m, t

    straight_logs, sm, straight = run([])
    cut_logs, cm, _ = run([_SigtermAt(5)], tmp_path)
    assert cm.stop_training and len(cut_logs) == 5
    from paddle_tpu_torch.distributed.checkpoint import committed_steps
    assert committed_steps(str(tmp_path)) == [2, 4, 5]
    rest_logs, rm, resumed = run([], tmp_path)
    assert len(rest_logs) == len(straight_logs) - 5
    assert [x["loss"] for x in cut_logs + rest_logs] == \
        [x["loss"] for x in straight_logs]
    _bits(_state(resumed), _state(straight))
    assert rm._optimizer._step_count == sm._optimizer._step_count
    for p, q in zip(rm._optimizer._parameter_list,
                    sm._optimizer._parameter_list):
        torch.testing.assert_close(
            rm._optimizer._accumulators[id(p)]["velocity"],
            sm._optimizer._accumulators[id(q)]["velocity"], rtol=0, atol=0)


def test_visualdl_and_wandb_write_json_lines(tmp_path):
    import json
    _, t = _pair()
    cbs = [tp.callbacks.VisualDL(str(tmp_path / "vdl")),
           tp.callbacks.WandbCallback(dir=str(tmp_path / "wb"))]
    logs, _ = _fit(tp, t, tp.io.TensorDataset(list(_data(16))),
                   callbacks=cbs)
    for d in ("vdl", "wb"):
        recs = [json.loads(x) for x in
                open(tmp_path / d / "vdlrecords.jsonl")]
        train = [r["value"] for r in recs if r["tag"] == "train/loss"]
        assert train == [x["loss"] for x in logs]


# --------------------------------------------------- GradientMergeOptimizer

def test_gradient_merge_train_step_matches_jax():
    """``TrainStep(model, GradientMergeOptimizer(SGD, k_steps=2))`` takes
    K = 2 stacked microbatches a call in both packages: 3 calls, the
    losses and the state; ``avg=False`` sums (the port's own check against
    ``accumulate_steps=2, average_grads=False``, bit for bit)."""
    x, y = _data(24)
    xs = np.stack(np.split(x, 6)).reshape(3, 2, 4, 3, 8, 8)
    ys = np.stack(np.split(y, 6)).reshape(3, 2, 4)

    def loss_net(pkg, net):
        class L(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.net = net

            def forward(self, a, b):
                return pkg.nn.functional.cross_entropy(self.net(a), b)
        return L()

    j, t = _pair()
    runs = {}
    for pkg, net in ((jp, j), (tp, t)):
        merge = JaxGradientMerge if pkg is jp else GradientMergeOptimizer
        merged = merge(pkg.optimizer.SGD(0.1, parameters=net.parameters()),
                       k_steps=2)
        step = pkg.jit.TrainStep(loss_net(pkg, net), merged)
        runs[pkg] = [float(step(pkg.to_tensor(a), pkg.to_tensor(b)))
                     for a, b in zip(xs, ys)]
    for g, w in zip(runs[tp], runs[jp]):
        assert abs(g - w) <= LOSS_TOL * abs(w)
    _hold_states(_state(t), _state(j))
    states = []
    for merge in (True, False):
        _, t = _pair()
        opt = tp.optimizer.SGD(0.1, parameters=t.parameters())
        step = tp.jit.TrainStep(loss_net(tp, t),
                                GradientMergeOptimizer(opt, 2, avg=False)) \
            if merge else tp.jit.TrainStep(loss_net(tp, t), opt,
                                           accumulate_steps=2,
                                           average_grads=False)
        assert step._opt is opt and step._acc_steps == 2 and not step._avg
        for a, b in zip(xs, ys):
            step(tp.to_tensor(a), tp.to_tensor(b))
        states.append(_state(t))
    _bits(states[0], states[1])


def test_gradient_merge_eager_matches_jax():
    """The eager merge buffer: 4 ``backward`` / ``step`` / ``clear_grad``
    rounds at k_steps 2 apply 2 updates, as the JAX wrapper's."""
    x, y = _data(16)
    j, t = _pair()
    for pkg, net in ((jp, j), (tp, t)):
        merge = JaxGradientMerge if pkg is jp else GradientMergeOptimizer
        opt = merge(pkg.optimizer.SGD(0.1, parameters=net.parameters()),
                    k_steps=2)
        for i in range(4):
            loss = pkg.nn.functional.cross_entropy(
                net(pkg.to_tensor(x[4 * i:4 * i + 4])),
                pkg.to_tensor(y[4 * i:4 * i + 4]))
            loss.backward()
            opt.step()
            opt.clear_grad()
    _hold_states(_state(t), _state(j))


# ------------------------------------------------------------ async metrics

def test_async_scalar_and_metric_drain_on_the_cpu():
    """On the CPU a handle is ready at once; the drain pops in step order,
    forcing the oldest past its lag."""
    from paddle_tpu_torch.hapi import AsyncScalar, MetricDrain
    h = AsyncScalar(torch.tensor(2.5))
    assert h.is_ready() and float(h) == 2.5 and repr(h) == "AsyncScalar(2.5)"
    d = MetricDrain(max_lag=2)
    for s in range(4):
        d.push(s, [AsyncScalar(torch.tensor(float(s))), 0.5])
    assert d.ready() == [(s, [float(s), 0.5]) for s in range(4)]
    assert d.flush() == [] and d.forced_syncs == 0
    with pytest.raises(ValueError):
        MetricDrain(max_lag=0)
