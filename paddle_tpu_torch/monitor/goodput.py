"""Goodput & MFU accounting — where every second and every FLOP goes
(counterpart of ``paddle_tpu/monitor/goodput.py``).

The monitor's registry says *what* the run is doing and the tracer says
*which* request/step was slow; neither says where the run's wall-clock and
FLOP budget went in aggregate — the number every MFU lever is judged by.
This module is that accounting plane, two ledgers over the hooks the
monitor already receives:

* **FLOP ledger per program** — at every mint (a TrainStep's first call
  at a new input signature, an engine program's first call) the caller
  hands over a measured count (``FlopCount``) next to the analytical
  ``6·N·D`` model (``2·N·D`` for inference), kept as fallback *and*
  cross-check. **MFU and HFU are reported separately**: activation
  recompute replays forward FLOPs, so the hardware executes more FLOPs
  than the model's math requires — ``mfu/hfu`` counts what the card ran
  (measured), ``mfu/mfu`` counts what the model needed (the analytic
  number when recompute is on; they coincide otherwise).

* **wall-clock goodput ledger** — every interval the monitor hooks report
  (step dispatches, compile walls, serving decode/prefill executions,
  scheduler overhead) lands as a ``(t0, t1, state, priority)`` interval; a
  boundary sweep folds them into a **gap-free, non-overlapping**
  per-state timeline. Overlaps are resolved by priority, the uncovered
  remainder is ``idle``, and the cumulative ``goodput/{state}_s`` gauges
  always sum to ``goodput/wall_s`` exactly — ``goodput/fraction`` is
  ``productive_s / sum(state_s)`` by construction.

**What the measured count includes.** The JAX package reads XLA's
``cost_analysis()`` of the compiled executable. The port has no compiled
program to ask, so ``FlopCount`` counts one eager call: the dispatcher's
operations through ``torch.utils.flop_counter.FlopCounterMode`` (matrix
products, convolutions, attention ops; elementwise work counts zero, as
in XLA's count it is small), plus what the hand-written kernels report.
Those launch through ``ctypes`` (``kernels/_build.py``), not through the
dispatcher, so the counter cannot see them: each flash wrapper reports
its launch's score and context products itself (``kernel_flops``),
forward (2 products) and backward (5: the recomputed scores, dP, dV, dQ,
dK), over the (query, key) pairs it computes (causal: the lower
triangle). On the CPU a wrapper runs its plain version outside the count
(``uncounted``) and reports the same number, so the count does not
depend on the device. A call inside a CUDA-graph capture is never
counted: a program is counted on its eager warm-up run. The JAX count
misses its Pallas kernels the same way (they pass no ``cost_estimate``;
ROADMAP Queue 3), so on a TPU the JAX HFU leaves attention out.

Peak FLOPs resolve from the device-kind table below (the H100 only: the
port runs on nothing else) with the ``PADDLE_PEAK_FLOPS`` env override —
an unknown card degrades to flop *counts* without utilization ratios,
never to a wrong ratio.

Cost contract: the ledger only runs inside monitor hook bodies — the
disabled path is still the one ``monitor._active is None`` check, and a
kernel's report is one module-global ``None`` check.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

__all__ = ["GOODPUT_STATES", "PEAK_FLOPS", "GoodputLedger", "FlopCount",
           "analytic_train_flops_per_token", "executable_cost_stats",
           "device_peak_flops", "refresh_active", "kernel_flops",
           "counting", "uncounted", "attention_flops"]

# the gap-free timeline's states, in the (fixed) order every consumer sums
# them: goodput/fraction == productive_s / sum(<state>_s over this order)
GOODPUT_STATES = ("productive", "compile", "data_wait", "ckpt", "reshard",
                  "overhead", "idle")

# interval precedence for overlapping events, high wins. "ckpt_bg" is an
# ASYNC checkpoint write: it runs on a background thread under live steps,
# so it ranks below EVERY foreground state (productive dispatch AND host
# overhead brackets) and may only claim otherwise-idle time — hidden work
# is not lost time; a sync/emergency save blocks the loop and ranks above
# the dispatch it displaced.
_PRIORITY = {"compile": 60, "reshard": 50, "ckpt": 40, "data_wait": 30,
             "productive": 20, "overhead": 10, "ckpt_bg": 5}

# priority name -> exported state name (the two ckpt priorities are one
# accounting bucket)
_STATE_OF = {"ckpt_bg": "ckpt"}

# peak dense bf16 tensor-core FLOP/s per card by device name (prefix match
# on torch.cuda.get_device_name()); extend via env PADDLE_PEAK_FLOPS on
# names this table does not know. Sources: NVIDIA H100 Tensor Core GPU
# datasheet — H100 SXM5: 1,979 TFLOPS bf16 with 2:4 sparsity, 989.5 dense
# (torch names the SXM5 part "NVIDIA H100 80GB HBM3"); H100 PCIe: 1,513
# TFLOPS with sparsity, 756 dense
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA H100 SXM": 989e12,
              "NVIDIA H100 PCIe": 756e12}

# fold the pending interval buffer into the cumulative sweep once it holds
# this many entries (amortizes the O(n log n) sweep to ~O(log n) per event)
_FOLD_AT = 512


# ---------------------------------------------------------------- counting
#
# The open counting windows of this process, innermost last. A kernel
# wrapper's report is one check of this list when none is open.
_windows: list = []


class FlopCount:
    """Context manager: count the FLOPs of the work run inside it — the
    dispatcher's operations (``FlopCounterMode``) plus what the
    hand-written kernels report (``kernel_flops``). ``flops`` is the total,
    ``kernel`` the kernels' share (the attention products on the flash
    paths). Never open one around a CUDA-graph capture."""

    def __init__(self):
        self.kernel = 0.0
        self._mode = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        _windows.append(self)
        return self

    def __exit__(self, *exc):
        _windows.remove(self)
        self._mode.__exit__(*exc)
        return False

    @property
    def flops(self) -> float:
        return float(self._mode.get_total_flops()) + self.kernel


def counting() -> bool:
    """True while a ``FlopCount`` is open (a wrapper then reports)."""
    return bool(_windows)


def kernel_flops(n: float) -> None:
    """A hand-written kernel's launch did ``n`` FLOPs (no-op unless a
    ``FlopCount`` is open)."""
    if _windows:
        _windows[-1].kernel += float(n)


@contextmanager
def uncounted():
    """Run a kernel's plain version outside the open counts (its wrapper
    reports the kernel's FLOPs instead): every dispatch mode is popped for
    the duration, so nothing inside reaches a mode."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


def attention_flops(b: int, h: int, pairs: int, d: int,
                    backward: bool = False) -> float:
    """The score and context products of a flash launch over ``pairs``
    (query, key) pairs a head: 2 products forward (S = QK^T, O = PV), 5
    backward (S again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q),
    2·pairs·d FLOPs each."""
    return (10.0 if backward else 4.0) * b * h * pairs * d


def causal_pairs(lq: int, lk: int) -> int:
    """(query, key) pairs under a causal mask with the queries at the end
    of the keys (row i sees keys up to lk - lq + i)."""
    off = lk - lq
    return sum(min(max(off + i + 1, 0), lk) for i in range(lq)) \
        if off else lq * (lq + 1) // 2


def executable_cost_stats(count) -> Optional[dict]:
    """``{"flops", "bytes"}`` of one mint's ``FlopCount`` (None when there
    was none, or it counted nothing). ``bytes`` is None: the count sees no
    memory traffic, where XLA's analysis reports bytes accessed."""
    if count is None:
        return None
    flops = count.flops
    if not flops > 0:
        return None
    return {"flops": float(flops), "bytes": None}


def analytic_train_flops_per_token(n_params, num_layers=None,
                                   hidden_size=None, seq=None) -> float:
    """The analytic training FLOP model, ONE copy for bench.py and the
    ledger: 6 FLOPs per parameter per token (fwd 2 + bwd 4) plus the
    attention-dot term 12·L·d·S per token (scores + context, fwd+bwd),
    which parameter counting misses entirely. ``n_params`` is the caller's
    choice of parameter population — bench passes matmul params only
    (block weights + tied lm-head), the TrainStep ledger passes all
    trainable params (it cannot classify them; embeddings/norms add ~0.5%
    at GPT-medium scale)."""
    f = 6.0 * float(n_params)
    if num_layers and hidden_size and seq:
        f += 12.0 * num_layers * hidden_size * seq
    return f


def device_peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak FLOP/s for one card: env ``PADDLE_PEAK_FLOPS`` wins (the
    escape hatch for names the table does not know — without it an
    unknown card reports no MFU), else the table above by device-name
    prefix (``torch.cuda.get_device_name()`` when no name is given), else
    None."""
    env = os.environ.get("PADDLE_PEAK_FLOPS")
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            device_kind = torch.cuda.get_device_name(0)
        except Exception:
            return None
    return next((v for k, v in PEAK_FLOPS.items()
                 if str(device_kind).startswith(k)), None)


class _ExeCost:
    """One executable's ledger entry (per TrainStep bucket / engine exe)."""

    __slots__ = ("label", "flops", "bytes", "analytic", "tokens",
                 "recompute")

    def __init__(self, label, flops, nbytes, analytic, tokens, recompute):
        self.label = label
        self.flops = flops            # measured FLOPs / call (FlopCount)
        self.bytes = nbytes
        self.analytic = analytic      # 6ND (train) / 2ND (serve) fallback
        self.tokens = tokens          # tokens one full call processes
        self.recompute = recompute    # measured FLOPs include remat replays

    def hw_flops_per_call(self):
        """What the hardware executes per call (HFU numerator)."""
        return self.flops if self.flops is not None else self.analytic

    def model_flops_per_call(self):
        """What the model's math requires per call (MFU numerator): with
        recompute the measured count conflates replays in, so the analytic
        model is the model-FLOPs source; without it the measured count IS
        the model (analytic only a fallback)."""
        if self.recompute and self.analytic is not None:
            return self.analytic
        return self.flops if self.flops is not None else self.analytic


class GoodputLedger:
    """Both ledgers over one monitor session's registry.

    All mutation happens inside monitor hook bodies (training thread,
    loader consumer, async checkpoint writer, publisher refresh), so every
    public method takes the ledger lock. Gauges are refreshed on every
    fold and on :meth:`refresh` (wired into counters emission, Prometheus
    rendering and the fleet publisher) — between refreshes only ``idle``
    can go stale, by at most one publish interval."""

    def __init__(self, registry, emit=None, peak: Optional[float] = None):
        self.registry = registry
        self._emit = emit
        self._lock = threading.Lock()
        self._anchor = time.perf_counter()
        self._cum = {s: 0.0 for s in GOODPUT_STATES if s != "idle"}
        self._pending = []            # (t0, t1, priority_name)
        self._folded_until = self._anchor
        # merged union of already-ATTRIBUTED time (folded sweeps + late
        # claims): a long interval reported after a concurrent refresh
        # folded past it (a 60s async ckpt write under a 5s fleet
        # publisher) claims exactly the gaps nothing else owned, instead
        # of losing its whole pre-watermark span to idle
        self._covered = []            # sorted disjoint (start, end)
        self._exes = {}               # (kind, key) -> _ExeCost
        self._latest = {}             # kind -> _ExeCost (jit-path fallback)
        self._hw_flops = 0.0
        self._model_flops = 0.0
        self._serve_tokens = 0
        self._serve_decode_s = 0.0    # decode-active time: the tokens/s basis
        # model FLOPs attributed to GENERATED tokens (decode + accepted
        # speculative): serve/flops_per_token's numerator. Rejected-draft
        # verify FLOPs never land here — they ride _hw_flops (HFU) only.
        self._serve_model_flops = 0.0
        self._tp = 1
        self._peak = peak
        self._peak_resolved = peak is not None

    # ------------------------------------------------------------- exe ledger

    def record_executable(self, kind: str, key, count, *,
                          tokens_per_call=None, analytic_flops=None,
                          recompute: bool = False, label: Optional[str]
                          = None, devices: int = 1):
        """A new program minted: capture its measured count (a
        ``FlopCount``, or None) next to the analytic model. ``kind`` groups
        buckets ("train" / "serve"), ``key`` identifies the bucket within
        it. ``devices``: how many cards the program spans; the global
        analytic divides by it so every MFU/HFU ratio is a per-card figure
        against one card's peak."""
        stats = executable_cost_stats(count)
        devices = max(int(devices or 1), 1)
        rec = _ExeCost(label or f"{kind}_{key}",
                       stats["flops"] if stats else None,
                       stats["bytes"] if stats else None,
                       float(analytic_flops) / devices
                       if analytic_flops else None,
                       int(tokens_per_call) if tokens_per_call else None,
                       bool(recompute))
        with self._lock:
            self._exes[(kind, key)] = rec
            self._latest[kind] = rec
        g = self.registry.gauge
        if rec.flops is not None:
            g(f"mfu/{rec.label}/flops").set(rec.flops)
            g(f"mfu/{rec.label}/bytes").set(rec.bytes or 0)
        if rec.analytic is not None:
            g(f"mfu/{rec.label}/analytic_flops").set(rec.analytic)
        if rec.flops is not None and rec.tokens:
            g(f"mfu/{rec.label}/flops_per_token").set(rec.flops / rec.tokens)
        if self._emit is not None:
            self._emit("exec_cost", ledger=kind, label=rec.label,
                       flops=rec.flops, bytes=rec.bytes,
                       analytic_flops=rec.analytic,
                       tokens_per_call=rec.tokens, recompute=rec.recompute)
        return rec

    def drop_kind(self, kind: str, owner=None):
        """Executables of ``kind`` were dropped (fast-state drop rebuilds
        renumber TrainStep buckets from 1): stale per-bucket entries would
        misattribute FLOPs to dead programs. ``owner`` narrows the drop to
        one instance's entries (keys shaped ``(owner, ...)``) — a sibling
        TrainStep/engine sharing the session keeps its ledger."""
        with self._lock:
            for k in [k for k in self._exes if k[0] == kind]:
                key = k[1]
                if owner is not None and not (
                        isinstance(key, tuple) and key
                        and key[0] == owner):
                    continue
                del self._exes[k]
            self._latest.pop(kind, None)

    def set_tp(self, tp: int):
        with self._lock:
            self._tp = max(int(tp), 1)

    # -------------------------------------------------------- interval ledger

    def add(self, state: str, t0: float, t1: float):
        """One completed interval on the ``time.perf_counter`` clock.
        Out-of-order and overlapping arrivals are fine — the sweep
        resolves them; an interval reaching back before the fold
        watermark is clipped (never double-counted)."""
        with self._lock:
            self._add_locked(state, t0, t1)

    def _add_locked(self, state, t0, t1):
        t0 = max(float(t0), self._anchor)
        t1 = float(t1)
        if t1 <= t0:
            return
        wm = self._folded_until
        if t0 < wm:
            # the interval reaches into the already-folded region: claim
            # only the sub-ranges nothing else has been attributed (they
            # were idle in the fold) — never re-claim attributed time, so
            # the no-double-count invariant holds regardless of refresh
            # cadence
            self._claim_uncovered_locked(state, t0, min(t1, wm))
            t0 = wm
            if t1 <= t0:
                return
        self._pending.append((t0, t1, state))
        if len(self._pending) >= _FOLD_AT:
            self._fold_locked()
            self._refresh_locked(time.perf_counter())

    def _claim_uncovered_locked(self, state, t0, t1):
        st = _STATE_OF.get(state, state)
        claimed = []
        cur = t0
        for s, e in self._covered:
            if e <= cur:
                continue
            if s >= t1:
                break
            if s > cur:
                self._cum[st] += s - cur
                claimed.append((cur, s))
            cur = max(cur, e)
            if cur >= t1:
                break
        if cur < t1:
            self._cum[st] += t1 - cur
            claimed.append((cur, t1))
        if claimed:
            # the claims become covered too: a second late interval over
            # the same past gap cannot count it again
            self._covered.extend(claimed)
            self._merge_covered_locked()

    def _merge_covered_locked(self):
        segs = sorted(self._covered)
        out = []
        for s, e in segs:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        if len(out) > 1024:
            # bound memory: collapse the oldest gaps into one conservative
            # span — late claims beyond the retained horizon are dropped
            # (the pre-existing clipping behavior), never double-counted
            k = len(out) - 512
            out = [(self._anchor, out[k - 1][1])] + out[k:]
        self._covered = out

    def dispatch(self, kind: str, key, t0: float, t1: float, tokens=None,
                 generated: bool = False, host_t0=None):
        """A productive execution of one ledgered executable: the interval
        lands as ``productive`` (``host_t0``: the pre-dispatch host
        bookkeeping since the step entered, as ``overhead``), and the
        executable's FLOPs accrue to the HFU/MFU totals. ``tokens`` scales
        the *model* FLOPs to the useful fraction of the call (live slots
        of a fixed-shape decode step, valid tokens of a padded chunk) —
        the hardware ran the full program either way, which is exactly
        the serving HFU-vs-MFU gap. ``generated`` marks tokens that were
        PRODUCED (decode steps): only those count toward the serving
        throughput figure — prefill prompt tokens scale FLOPs but are not
        generation throughput (they'd inflate tokens/s ~promptlen/outlen
        on prefill-heavy workloads)."""
        with self._lock:
            self._add_locked("productive", t0, t1)
            if host_t0 is not None:
                self._add_locked("overhead", host_t0, t0)
            rec = self._exes.get((kind, key)) or self._latest.get(kind)
            attributed = 0.0
            if rec is not None:
                hw = rec.hw_flops_per_call()
                model = rec.model_flops_per_call()
                scale = 1.0
                if tokens is not None and rec.tokens:
                    scale = min(max(tokens, 0) / rec.tokens, 1.0)
                if hw:
                    self._hw_flops += hw
                if model:
                    attributed = model * scale
                    self._model_flops += attributed
            if generated:
                # tokens/s basis is DECODE-ACTIVE time, not session wall: a
                # burst's throughput must not dilute against unrelated
                # training/idle time in the same session, nor decay once
                # the burst ends
                self._serve_decode_s += max(t1 - t0, 0.0)
                if tokens:
                    self._serve_tokens += int(tokens)
                if attributed:
                    self._serve_model_flops += attributed

    # ------------------------------------------------------------------ sweep

    def _fold_locked(self):
        """Boundary sweep over the pending buffer: every instant covered
        by at least one interval is attributed to the highest-priority
        covering interval (ties break deterministically by state name),
        so states never overlap and their sum never exceeds wall time."""
        import heapq
        if not self._pending:
            return
        ivs = sorted(self._pending)
        self._pending = []
        bounds = sorted({t for iv in ivs for t in (iv[0], iv[1])})
        heap, i = [], 0
        for a, b in zip(bounds, bounds[1:]):
            while i < len(ivs) and ivs[i][0] <= a:
                t0, t1, st = ivs[i]
                heapq.heappush(heap, (-_PRIORITY.get(st, 0), st, t1))
                i += 1
            while heap and heap[0][2] <= a:
                heapq.heappop(heap)
            if heap:
                st = _STATE_OF.get(heap[0][1], heap[0][1])
                self._cum[st] += b - a
                self._covered.append((a, b))
        self._folded_until = max(self._folded_until, bounds[-1])
        self._merge_covered_locked()

    # ---------------------------------------------------------------- refresh

    def _peak_flops(self):
        if not self._peak_resolved:
            self._peak = device_peak_flops()
            self._peak_resolved = True
        return self._peak

    def refresh(self, now: Optional[float] = None) -> dict:
        """Fold + export: the ``goodput/*`` and ``mfu/*`` gauges as of
        ``now``. Returns the per-state seconds (tests and ``snapshot``
        consumers read the dict; everything else reads the gauges)."""
        with self._lock:
            self._fold_locked()
            return self._refresh_locked(
                time.perf_counter() if now is None else now)

    def _refresh_locked(self, now):
        wall = max(now - self._anchor, 0.0)
        covered = sum(self._cum.values())
        vals = dict(self._cum)
        vals["idle"] = max(wall - covered, 0.0)
        # the exported identity: fraction = productive / sum(states), the
        # sum taken in GOODPUT_STATES order so any consumer summing the
        # gauges the same way reconstructs the fraction EXACTLY
        total = sum(vals[s] for s in GOODPUT_STATES)
        g = self.registry.gauge
        for s in GOODPUT_STATES:
            g(f"goodput/{s}_s").set(vals[s])
        g("goodput/wall_s").set(wall)
        frac = vals["productive"] / total if total > 0 else 0.0
        g("goodput/fraction").set(frac)
        if self._hw_flops:
            g("mfu/hw_flops").set(self._hw_flops)
            g("mfu/model_flops").set(self._model_flops)
            peak = self._peak_flops()
            if peak and wall > 0:
                g("mfu/peak_flops").set(peak)
                g("mfu/hfu").set(self._hw_flops / (wall * peak))
                g("mfu/mfu").set(self._model_flops / (wall * peak))
        if self._serve_tokens and self._serve_decode_s > 0:
            g("serve/tokens_per_s_chip").set(
                self._serve_tokens / self._serve_decode_s / self._tp)
        if self._serve_tokens and self._serve_model_flops:
            # per-ACCEPTED-token model cost: a speculative verify bills
            # its model FLOPs pre-scaled by emitted/width, so rejected
            # drafts cannot shrink (or inflate) this figure
            g("serve/flops_per_token").set(
                self._serve_model_flops / self._serve_tokens)
        vals["wall"] = wall
        vals["fraction"] = frac
        return vals


# ------------------------------------------------------------- module plane

# the enabled monitor session's ledger (set by monitor.enable, cleared on
# teardown): lets the fleet publisher freshen the gauges it is about to
# snapshot without holding a reference into the Monitor object
_active_ledger: Optional[GoodputLedger] = None


def _set_active(ledger: Optional[GoodputLedger]):
    global _active_ledger
    _active_ledger = ledger


def refresh_active():
    """Fold + re-export the active ledger's gauges (no-op when the monitor
    is down). The fleet publisher calls this right before its registry
    snapshot so the wire always carries a current idle/fraction figure."""
    led = _active_ledger
    if led is not None:
        try:
            led.refresh()
        except Exception:
            pass  # telemetry must never take down the publisher loop
