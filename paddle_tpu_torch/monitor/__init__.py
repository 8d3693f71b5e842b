"""paddle_tpu_torch.monitor — always-on structured runtime telemetry
(counterpart of ``paddle_tpu/monitor``).

What the run is doing, all the time:

* a metric **registry** (Counter/Gauge/Histogram) + buffered **JSONL sink**
  — one schema-versioned record per step/event, per-process files under the
  launcher's env contract; the records are the JAX package's, kind for
  kind and field for field, so ``tools/metrics_summary.py``,
  ``tools/goodput_report.py``, ``tools/trace_view.py`` and
  ``tools/fleet_prom.py`` read the port's files unchanged;
* a **recompile sentinel** — a ``TrainStep`` call at a new input
  signature (the eager step's counterpart of an AOT mint) and every
  serving program built emit the signature, the running count and the
  measured FLOPs, with a ``warn_after=N`` diagnostic naming the divergent
  leaf shapes;
* **memory accounting** — each serving program's footprint measured
  around its capture, and a census of live CUDA tensors on demand;
* a **flight recorder** — a bounded ring of recent events dumped to JSON on
  an exception escaping ``TrainStep`` (or ``dump()``);
* the **span tracer** (``trace.py``), the **goodput/MFU ledger**
  (``goodput.py``, the H100's peak), the **health plane** (``health.py``)
  and the online **fleet collector** (``collector.py``: per-rank
  publishers, rank 0's aggregator and its ``run.fleet.jsonl``).

Enable with ``monitor.enable("run.jsonl", trace=True)`` or env
``PADDLE_MONITOR=path`` (``PADDLE_TRACE``, ``PADDLE_TRACE_SAMPLE``).
Disabled cost: every integration point guards on one module-global
``monitor._active is None`` check, so the hot path stays a no-op.

Not ported: the per-op dispatch hooks (the port has no dispatcher of its
own: ROADMAP Queue 1, item 1).
"""
from __future__ import annotations

import atexit
import os
import threading
import time
import warnings
from typing import Optional

from . import goodput as _goodput_mod
from . import health as _health_mod
from . import prom as _prom
from . import trace as _trace_mod
from .goodput import GOODPUT_STATES, GoodputLedger
from .health import HealthPlane
from .memory import executable_memory_stats, live_array_census
from .recorder import FlightRecorder
from .registry import Counter, Gauge, Histogram, Registry
from .sink import SCHEMA_VERSION, JsonlSink, resolve_sink_path

__all__ = ["enable", "disable", "enabled", "get", "emit", "dump",
           "counter", "gauge", "histogram", "snapshot", "fleet_state",
           "on_crash",
           "live_array_census", "executable_memory_stats", "prom_render",
           "Monitor", "Registry", "Counter", "Gauge", "Histogram",
           "GoodputLedger", "GOODPUT_STATES", "HealthPlane",
           "SCHEMA_VERSION"]

# THE hot-path flag: integration points read this one module global and do
# nothing when it is None. Everything else in this file is cold path.
_active: Optional["Monitor"] = None

_lock = threading.Lock()

# consumer-visible stall threshold: a q.get() that returns in under 1ms was
# not a stall, it was queue bookkeeping (loader_wait: no caller yet)
_STALL_S = 1e-3

# event kinds that embed the active trace_id when the span tracer is up —
# the WARN/anomaly records an operator follows FROM metrics INTO a trace.
# ONLY kinds whose emitter runs INSIDE the implicated trace's own live
# context belong here (the backfill reads "this thread's current / most
# recent trace"). Excluded on purpose: fleet_warn / serve_preempt /
# serve_page_reject name a DIFFERENT actor's trace (their emitters attach
# it explicitly when known), and between-steps emitters (loader_stall,
# ckpt_save, preemption) would name the PREVIOUS — already ended, possibly
# unsampled — step while their floating spans land in the NEXT one.
_TRACED_KINDS = frozenset((
    "recompile", "skip_update", "fast_state_dropped", "serve_reject",
    "crash", "health_nan", "health_overflow", "health_spike"))


def _sig_json(sig):
    """Input signature tuple -> JSON-ready list (shapes/dtypes/shardings)."""
    out = []
    for entry in sig:
        try:
            shape, dtype, sharding = entry
            out.append({"shape": list(shape), "dtype": str(dtype),
                        "sharding": str(sharding)})
        except Exception:
            out.append({"repr": repr(entry)})
    return out


def _sig_divergence(prev, new):
    """Name the leaves that changed between two input signatures — the
    actionable half of a recompile event ("input[1].shape (16,128)->(16,256)"
    points straight at the bucketing boundary that leaked)."""
    if prev is None:
        return []
    diffs = []
    if len(prev) != len(new):
        diffs.append(f"arity {len(prev)}->{len(new)}")
    for i, (p, n) in enumerate(zip(prev, new)):
        pshape, pdt, pshard = p
        nshape, ndt, nshard = n
        if tuple(pshape) != tuple(nshape):
            diffs.append(f"input[{i}].shape {tuple(pshape)}->{tuple(nshape)}")
        if str(pdt) != str(ndt):
            diffs.append(f"input[{i}].dtype {pdt}->{ndt}")
        if str(pshard) != str(nshard):
            diffs.append(f"input[{i}].sharding {pshard}->{nshard}")
    return diffs


class Monitor:
    """One enabled telemetry session (registry + sink + flight recorder)."""

    def __init__(self, path: Optional[str] = None, *,
                 warn_after: Optional[int] = None, flush_every: int = 64,
                 ring: int = 256):
        self.registry = Registry()
        self.sink = JsonlSink(path, flush_every) if path else None
        self.flight = FlightRecorder(ring)
        # goodput/MFU accounting plane (monitor/goodput.py): consumes the
        # hooks below, costs nothing new on the disabled path
        self.goodput = GoodputLedger(self.registry, emit=self.emit)
        # model-health plane (monitor/health.py): numerics tripwires,
        # per-layer stats, spike rollback, divergence digests. Rides every
        # session unless PADDLE_HEALTH=0; the disabled path is still the
        # one `monitor._active is None` check at each integration point.
        self.health = _health_mod.HealthPlane(self)
        self.warn_after = warn_after
        # per-op dispatch counts of the Paddle surface (op_hook)
        self._op_counts = {}
        self._op_compiles = 0
        self._t0 = time.time()
        self.emit("meta", schema=SCHEMA_VERSION, pid=os.getpid(),
                  proc=int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0),
                  start=self._t0)

    # ------------------------------------------------------------- plumbing

    def emit(self, kind: str, **fields):
        """One event record: into the flight-recorder ring always, into the
        JSONL sink when one is attached. Anomaly/WARN kinds embed the span
        tracer's active trace_id when one is up, so a WARN in the metrics
        stream names the trace to open in tools/trace_view.py."""
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "kind": kind}
        rec.update(fields)
        if kind in _TRACED_KINDS and "trace" not in rec:
            tracer = _trace_mod._active
            if tracer is not None:
                tid = tracer.current_trace_id()
                if tid:
                    rec["trace"] = tid
        self.flight.push(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def _emit_counters(self):
        # freshen the goodput/mfu gauges first: the counters record is the
        # snapshot offline tooling reads, its idle/fraction must be current
        try:
            self.goodput.refresh()
        except Exception:
            pass
        snap = self.registry.snapshot()
        # copy first: op_hook inserts first-seen op names as it goes, and
        # iterating the live dict would raise mid-dump
        snap["counters"].update({f"op/{k}": v
                                 for k, v in sorted(dict(self._op_counts)
                                                    .items())})
        self.emit("counters", metrics=snap)
        return snap

    # -------------------------------------------------- integration: dispatch

    def op_hook(self, name: str):
        """Count one dispatch of the op ``name`` (``core.dispatch``)."""
        c = self._op_counts
        c[name] = c.get(name, 0) + 1

    def op_compile_hook(self, name: str, attr_key):
        """The JAX package's per-op executable mint. Eager torch mints none,
        so ``core.dispatch`` never calls it; it is installed for the
        signature's sake."""
        self._op_compiles += 1
        self.registry.counter("dispatch/op_compiles").inc()
        self.emit("op_compile", name=name, attrs=repr(attr_key),
                  count=self._op_compiles)

    def flush(self):
        if self.sink is not None:
            self.sink.flush()

    def close(self):
        self._emit_counters()
        if self.sink is not None:
            self.sink.close()

    # ------------------------------------------------ integration: train step

    def train_step_compiled(self, sig, prev_sig, compile_s: Optional[float],
                            count: int, path: str, cost=None,
                            tokens=None, analytic_flops=None,
                            recompute: bool = False, span=None,
                            devices: int = 1, step_id=None, program=None):
        """Recompile-sentinel entry: a TrainStep met a new input signature.

        path: "eager" (the port's step: its first call at the signature is
        the mint) — the JAX package's "aot" / "jit". Emits the recompile
        event, memory gauges when a captured ``program`` is handed over,
        and the warn_after diagnostic. ``cost`` (the mint call's
        ``goodput.FlopCount``) / ``tokens`` / ``analytic_flops`` /
        ``recompute`` feed the goodput plane's per-bucket FLOP ledger
        (measured, analytic 6ND as fallback + cross-check); ``span`` is
        the mint call's interval, whose compile wall is not separately
        measurable — the whole call classifies as compile time, as a JAX
        jit-path mint does.
        """
        gp = self.goodput
        # keyed per TrainStep instance (the engine_id pattern): two train
        # steps in one session never bill each other's dispatches; the
        # flat per-bucket gauges stay last-writer
        gp.record_executable("train", (step_id, count), cost,
                             tokens_per_call=tokens,
                             analytic_flops=analytic_flops,
                             recompute=recompute, devices=devices,
                             label=f"train_bucket{count}")
        if compile_s is not None:
            now = time.perf_counter()
            gp.add("compile", now - compile_s, now)
        elif span is not None:
            gp.add("compile", span[0], span[1])
        self.registry.counter("train_step/recompiles").inc()
        self.registry.gauge("train_step/executables").set(count)
        if compile_s is not None:
            self.registry.histogram("train_step/compile_s").observe(compile_s)
        divergent = _sig_divergence(prev_sig, sig)
        self.emit("recompile", path=path, count=count, compile_s=compile_s,
                  sig=_sig_json(sig), divergent=divergent)
        if program is not None:
            stats = executable_memory_stats(program)
            if stats is not None:
                g = self.registry.gauge
                g(f"train_step/bucket{count}/argument_bytes").set(
                    stats["argument_bytes"])
                g(f"train_step/bucket{count}/output_bytes").set(
                    stats["output_bytes"])
                g(f"train_step/bucket{count}/temp_bytes").set(
                    stats["temp_bytes"])
                g(f"train_step/bucket{count}/total_bytes").set(
                    stats["total_bytes"])
                peak = self.registry.gauge("train_step/hbm_peak_bytes")
                if stats["total_bytes"] > peak.value:
                    peak.set(stats["total_bytes"])
                self.emit("memory", bucket=count, sig=_sig_json(sig), **stats)
        if self.warn_after is not None and count > self.warn_after:
            why = "; ".join(divergent) if divergent \
                else "first signature unknown"
            tracer = _trace_mod._active
            tid = tracer.current_trace_id() if tracer is not None else None
            if tracer is not None:
                # always-sample-on-WARN: the step that tripped the sentinel
                # must survive head sampling
                tracer.escalate(reason="recompile_warn")
            warnings.warn(
                f"TrainStep recompiled {count} executables "
                f"(warn_after={self.warn_after}): {why}. Unplanned shape "
                f"churn defeats the bucketing contract — pad inputs to fixed "
                f"boundaries or add the new shape to the bucket set."
                + (f" [trace {tid}]" if tid else ""),
                RuntimeWarning, stacklevel=3)

    def step_event(self, dur_s: float, microbatches: int = 1, bucket=None,
                   span=None, host_t0=None, step_id=None):
        self.registry.counter("train_step/steps").inc()
        if microbatches > 1:
            self.registry.counter("train_step/microbatches").inc(microbatches)
        self.registry.histogram("train_step/dispatch_s").observe(dur_s)
        # goodput: the dispatch is productive time attributed to its shape
        # bucket's FLOP entry; host_t0 (the step's entry instant) books the
        # pre-dispatch host work as overhead
        if span is None:
            t1 = time.perf_counter()
            span = (t1 - dur_s, t1)
        self.goodput.dispatch("train", (step_id, bucket), span[0], span[1],
                              host_t0=host_t0)
        self.emit("step", dur_s=dur_s)

    # ------------------------------------------- integration: grad accumulation

    def accum_config(self, k: int, accumulator_bytes: int):
        """Gradient-accumulation gauges: microbatch count per update and the
        device memory held by the fp32 gradient accumulators."""
        self.registry.gauge("train_step/accumulate_steps").set(k)
        self.registry.gauge("train_step/grad_accumulator_bytes").set(
            accumulator_bytes)
        self.emit("accumulation", k=k, accumulator_bytes=accumulator_bytes)

    def shard_config(self, world: int, accum_bytes: int,
                     accum_ideal_bytes: int, opt_state_bytes: int,
                     buckets: int):
        """ZeRO sharding gauges: per-device residency of the fp32 grad
        accumulators (vs the 1/world_size ideal — a gap means a lost
        sharding constraint), per-device optimizer-state bytes, and how many
        fused reduce-scatter buckets the accumulation scan carries."""
        g = self.registry.gauge
        g("shard/world_size").set(world)
        g("shard/accum_bytes").set(accum_bytes)
        g("shard/accum_ideal_bytes").set(accum_ideal_bytes)
        g("shard/opt_state_bytes").set(opt_state_bytes)
        g("shard/grad_buckets").set(buckets)
        self.emit("sharding", world=world, accum_bytes=accum_bytes,
                  accum_ideal_bytes=accum_ideal_bytes,
                  opt_state_bytes=opt_state_bytes, buckets=buckets)

    def remat_compiled(self, requested: bool, regions: int, policy,
                       saved_name_bytes: int, named_bytes: dict,
                       baseline_total_bytes=None, saved_residual_bytes=None):
        """Activation-recompute gauges for a freshly minted step.

        ``requested`` = the model declared a recompute config;
        ``regions`` = recompute regions the mint call actually applied;
        ``saved_name_bytes`` = bytes of the named activations the call
        tagged. ``requested`` with ``regions == 0`` (or a selective policy
        with zero named bytes) is the lost-checkpoint signature — the
        recompute the user asked for silently fell out of the step.
        ``baseline_total_bytes``/``saved_residual_bytes`` are the JAX
        package's measured no-remat twin (``PADDLE_REMAT_BASELINE=1``); the
        port's eager step has no twin and passes None."""
        g = self.registry.gauge
        g("remat/requested").set(1 if requested else 0)
        g("remat/regions").set(regions)
        g("remat/saved_name_bytes").set(saved_name_bytes)
        fields = dict(requested=bool(requested), regions=regions,
                      policy=policy, saved_name_bytes=saved_name_bytes,
                      named_bytes=dict(named_bytes or {}))
        if baseline_total_bytes is not None:
            g("remat/baseline_total_bytes").set(baseline_total_bytes)
            g("remat/saved_residual_bytes").set(saved_residual_bytes or 0)
            fields.update(baseline_total_bytes=baseline_total_bytes,
                          saved_residual_bytes=saved_residual_bytes)
        self.emit("remat", **fields)

    def update_skipped(self, microbatches: int = 1):
        """AMP found-inf: the step discarded its whole update."""
        self.registry.counter("train_step/skipped_updates").inc()
        self.emit("skip_update", microbatches=microbatches)

    def placement_restored(self):
        """A user-installed array was device_put back to the compiled
        placement during fast-state refresh (cheaper than a recompile)."""
        self.registry.counter("train_step/placement_restores").inc()

    def fast_state_dropped(self, why: str, executables: int, step_id=None):
        """Fast-path executables dropped due to an unrestorable placement
        change; the next step re-lowers (recompile sentinel will fire)."""
        self.registry.counter("train_step/fast_state_drops").inc()
        # the rebuilt executables re-number from bucket 1: stale per-bucket
        # memory gauges would misattribute HBM to dead executables (same
        # rule for the goodput plane's per-bucket FLOP entries — dropped
        # for THIS TrainStep only, a sibling's entries stay live)
        self.registry.remove_prefix("train_step/bucket")
        self.registry.remove_prefix("mfu/train_bucket")
        self.goodput.drop_kind("train", owner=step_id)
        self.emit("fast_state_dropped", reason=why, executables=executables)

    # ---------------------------------------------------- integration: loader

    def loader_wait(self, wait_s: float, qsize: int, span=None):
        self.registry.counter("loader/batches").inc()
        self.registry.gauge("loader/queue_depth").set(qsize)
        self.registry.histogram("loader/wait_s").observe(wait_s)
        # goodput: consumer-visible feed wait is data_wait — the producer's
        # hidden fetch/H2D never reaches the ledger (hidden work is not
        # lost time)
        if span is None:
            t1 = time.perf_counter()
            span = (t1 - wait_s, t1)
        self.goodput.add("data_wait", span[0], span[1])
        if wait_s > _STALL_S:
            self.registry.counter("loader/stalls").inc()
            self.emit("loader_stall", wait_s=wait_s, qsize=qsize)

    # ------------------------------------------------------ integration: hapi

    def epoch_event(self, epoch: int, steps: int, wall_s: float, logs: dict):
        self.registry.counter("fit/epochs").inc()
        self.registry.histogram("fit/epoch_s").observe(wall_s)
        self.emit("epoch", epoch=epoch, steps=steps, wall_s=wall_s,
                  logs={k: float(v) for k, v in (logs or {}).items()})

    # ---------------------------------------------- integration: checkpointing

    def ckpt_saved(self, step: int, nbytes: int, dur_s: float, mode: str,
                   attempts: int = 1):
        """A snapshot committed. mode: "sync" | "async" | "emergency"."""
        self.registry.counter("ckpt/saves").inc()
        if mode == "emergency":
            self.registry.counter("ckpt/emergency_saves").inc()
        self.registry.gauge("ckpt/last_step").set(step)
        self.registry.gauge("ckpt/last_bytes").set(nbytes)
        self.registry.histogram("ckpt/save_s").observe(dur_s)
        # goodput: a sync/emergency save blocks the loop (ckpt time); an
        # async write runs under live steps and may only claim time nothing
        # foreground owns — the interval ledger's priorities encode that
        now = time.perf_counter()
        self.goodput.add("ckpt_bg" if mode == "async" else "ckpt",
                         now - dur_s, now)
        self.emit("ckpt_save", step=step, bytes=nbytes, dur_s=dur_s,
                  mode=mode, attempts=attempts)

    def ckpt_blocked(self, t0: float, t1: float):
        """Host time the fit loop spent inside save() (the async path's
        host snapshot; the whole write when blocking) — foreground
        checkpoint time for the goodput ledger, perf_counter interval."""
        self.goodput.add("ckpt", t0, t1)

    def ckpt_retry(self, step: int, attempt: int):
        """A snapshot write attempt failed transiently and is being retried."""
        self.registry.counter("ckpt/retries").inc()
        self.emit("ckpt_retry", step=step, attempt=attempt)

    def ckpt_corrupt(self, path: str, why: str,
                     quarantined: Optional[str] = None):
        """Auto-resume skipped a torn/corrupt snapshot (quarantined when it
        could be renamed out of the resume scan)."""
        self.registry.counter("ckpt/corrupt_skipped").inc()
        self.emit("ckpt_corrupt", path=path, why=why, quarantined=quarantined)

    def ckpt_resumed(self, step: int, path: str):
        self.registry.counter("ckpt/resumes").inc()
        self.emit("ckpt_resume", step=step, path=path)

    def preempted(self, signum: int):
        """A watched preemption signal arrived (SIGTERM/SIGINT)."""
        self.registry.counter("preempt/signals").inc()
        self.emit("preemption", signum=int(signum))

    def reshard_loaded(self, src_world: int, dst_world: int, arrays: int,
                       identity: int, mapped: int, gathered: int,
                       nestable_gather: int, bytes_read: int, wall_s: float):
        """A checkpoint restore resharded an N-way snapshot onto this mesh.

        ``nestable_gather`` counts arrays that fell back to the
        gather-then-re-place path even though the WORLD pair nests
        (N%M==0 or M%N==0) — an array's sharded dim moved between worlds,
        paying a full-size host buffer the index-mapped reader would have
        avoided. tools/metrics_summary.py WARNs on it."""
        g = self.registry.gauge
        g("reshard/src_world").set(src_world)
        g("reshard/dst_world").set(dst_world)
        g("reshard/arrays").set(arrays)
        g("reshard/arrays_identity").set(identity)
        g("reshard/arrays_mapped").set(mapped)
        g("reshard/arrays_gathered").set(gathered)
        g("reshard/bytes_read").set(bytes_read)
        self.registry.counter("reshard/loads").inc()
        now = time.perf_counter()
        self.goodput.add("reshard", now - wall_s, now)
        if nestable_gather:
            self.registry.counter("reshard/nestable_gather_fallbacks").inc(
                nestable_gather)
        self.registry.histogram("reshard/load_s").observe(wall_s)
        self.emit("reshard", src_world=src_world, dst_world=dst_world,
                  arrays=arrays, identity=identity, mapped=mapped,
                  gathered=gathered, nestable_gather=nestable_gather,
                  bytes_read=bytes_read, wall_s=wall_s)

    # ----------------------------------------------------- integration: serving

    def serve_engine(self, max_slots: int, max_len: int, buckets, quantize,
                     engine_id=None, paged=None, block_size=None,
                     kv_blocks=None, prefill_chunk=None, tp=1,
                     drafter=None):
        """A DecodeEngine came up: record its static geometry (paged
        engines add the block pool shape and the prefill chunk size; a
        mesh-native engine carries its tensor-parallel degree; a
        speculative engine names its drafter)."""
        g = self.registry.gauge
        g("serve/max_slots").set(max_slots)
        g("serve/max_len").set(max_len)
        if kv_blocks:
            g("serve/kv_blocks").set(kv_blocks)
            g("serve/block_size").set(block_size or 0)
        if tp and tp > 1:
            g("serve/tp").set(tp)
        self.goodput.set_tp(tp or 1)   # tokens/s/chip divides by the mesh
        self.emit("serve_engine", max_slots=max_slots, max_len=max_len,
                  prefill_buckets=list(buckets), quantize=quantize,
                  engine=engine_id, paged=paged, block_size=block_size,
                  kv_blocks=kv_blocks, prefill_chunk=prefill_chunk, tp=tp,
                  drafter=drafter)

    def serve_compiled(self, kind: str, bucket, compile_s: float, count: int,
                       engine_id=None, cost=None, tokens=None,
                       analytic_flops=None, devices: int = 1, program=None):
        """Serving recompile sentinel: the engine built a program (its
        first call: the eager warm-up and, on the card, the capture).
        kind: "prefill" (one per prompt-length bucket: the chunk and the
        row cache's prefill) | "decode" (exactly one per ENGINE, ever — a
        second decode mint from the same engine in steady state is a bug;
        `engine_id` lets a sink with several engines tell re-mints from a
        sibling engine's first mint) | "verify". ``cost`` (the warm-up's
        ``goodput.FlopCount``) / ``tokens`` / ``analytic_flops`` /
        ``devices`` feed the goodput FLOP ledger, keyed per ENGINE so two
        live engines in one session never bill each other's dispatches;
        ``program``'s footprint measured around its capture
        (``memory.executable_memory_stats``; None on the CPU) lands as a
        ``memory`` event."""
        label = f"serve_{kind}" + (str(bucket) if bucket else "")
        gp = self.goodput
        rec = gp.record_executable("serve", (engine_id, kind, bucket),
                                   cost, tokens_per_call=tokens,
                                   analytic_flops=analytic_flops,
                                   devices=devices, label=label)
        if kind == "decode" and rec.tokens:
            # per-token serving cost (model-FLOPs/token next to TTFT in
            # the reports) is a DECODE figure: a prefill bucket minting
            # later must not overwrite it with its own per-token cost
            mf = rec.model_flops_per_call()
            if mf is not None:
                self.registry.gauge("serve/model_flops_per_token").set(
                    mf / rec.tokens)
        now = time.perf_counter()
        gp.add("compile", now - compile_s, now)
        self.registry.counter("serve/compiles").inc()
        self.registry.counter(f"serve/compiles_{kind}").inc()
        self.registry.gauge("serve/executables").set(count)
        self.registry.histogram("serve/compile_s").observe(compile_s)
        self.emit("serve_compile", path=kind, bucket=bucket,
                  compile_s=compile_s, count=count, engine=engine_id)
        stats = executable_memory_stats(program) \
            if program is not None else None
        if stats is not None:
            self.emit("memory", bucket=label, **stats)

    def serve_request(self, queued: bool, error: Optional[str] = None,
                      overload: bool = False, draining: bool = False):
        """submit() outcome: admitted to the queue, or rejected at the door
        (malformed requests never reach a slot; ``overload`` marks a
        well-formed request bounced off a full admission queue;
        ``draining`` one bounced off a draining engine's closed door)."""
        if queued:
            self.registry.counter("serve/requests").inc()
        else:
            self.registry.counter("serve/rejected").inc()
            if overload:
                self.registry.counter("serve/rejected_overload").inc()
            if draining:
                self.registry.counter("serve/rejected_draining").inc()
            self.emit("serve_reject", error=error, overload=overload,
                      draining=draining)

    def serve_queue_wait(self, wait_s: float):
        """Time a request sat in the admission queue before its slot
        (saturation made visible: the queue is bounded, the wait is
        measured)."""
        self.registry.histogram("serve/queue_wait_s").observe(wait_s)

    def serve_page_reject(self, free_blocks: int, needed_blocks: int,
                          trace_id=None, pool_blocks: int = 0):
        """Paged admission refused for lack of KV blocks. ``free >=
        needed`` in this event is the allocator-bug signature (refusal
        without real pressure) that metrics_summary WARNs on — except
        when ``pool_blocks > 0``: the admission adopted that many blocks
        from the cross-process pool before refusing, so the adopted
        blocks legitimately sit between "free" and "needed" and the WARN
        predicate must skip the record. ``trace_id``: the refused
        REQUEST's trace (more precise than the generic most-recent-trace
        tag)."""
        self.registry.counter("serve/page_rejects").inc()
        fields = dict(free_blocks=int(free_blocks),
                      needed_blocks=int(needed_blocks))
        if pool_blocks:
            fields["pool_blocks"] = int(pool_blocks)
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_page_reject", **fields)

    def serve_preempted(self, nth: int, trace_id=None):
        """Pool pressure evicted a tenant back to the queue (its compute
        is redone on re-admission). ``trace_id``: the VICTIM request's
        trace."""
        self.registry.counter("serve/preemptions").inc()
        fields = dict(nth=int(nth))
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_preempt", **fields)

    def serve_nan_logits(self, where: str, trace_id=None):
        """The decode/prefill executable reported non-finite logits for a
        request; the engine terminalizes it as `failed` instead of
        streaming garbage tokens. ``where``: which executable tripped
        (prefill/chunk/decode/verify)."""
        self.registry.counter("serve/nan_logits").inc()
        fields = dict(where=where)
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_nan_logits", **fields)

    def serve_paged(self, pager_stats, kv_util: float, engine_id=None):
        """Per-decode-step paged-pool gauges (cheap sets, no event). The
        cumulative preemption count lives in the serve/preemptions COUNTER
        (serve_preempted), not a gauge here — a same-named gauge tripped
        the registry's no-silent-shadowing check. ``engine_id`` adds a
        per-engine ``serve/prefix_hits.eng<id>`` mirror so a multi-engine
        process (router bench/e2e) can attribute cache wins per replica —
        the affinity-beats-round-robin gate sums exactly these."""
        g = self.registry.gauge
        if engine_id is not None:
            g(f"serve/prefix_hits.eng{engine_id}").set(
                pager_stats.prefix_hits)
        g("serve/blocks_free").set(pager_stats.blocks_free)
        g("serve/blocks_used").set(pager_stats.blocks_used)
        g("serve/blocks_shared").set(pager_stats.blocks_shared)
        g("serve/block_refs").set(pager_stats.block_refs)
        g("serve/cow_copies").set(pager_stats.cow_copies)
        g("serve/kv_util").set(kv_util)
        g("serve/page_occupancy").set(
            pager_stats.blocks_used / pager_stats.blocks_total
            if pager_stats.blocks_total else 0.0)
        g("serve/sharing_ratio").set(
            pager_stats.block_refs / pager_stats.blocks_used
            if pager_stats.blocks_used else 1.0)
        # persistent prefix cache: parked-block occupancy + cumulative
        # cross-request adoption wins (metrics_summary's 0%-hit-with-
        # repeats WARN reads these alongside shared_hits)
        g("serve/lru_blocks").set(pager_stats.lru_blocks)
        g("serve/prefix_hits").set(pager_stats.prefix_hits)
        g("serve/prefix_hit_tokens").set(pager_stats.prefix_hit_tokens)
        g("serve/prefix_repeats").set(pager_stats.prefix_repeats)
        g("serve/shared_hits").set(pager_stats.shared_hits)
        # cross-process tier: splices that came from the shared pool
        # rather than the in-process registry (a subset of prefix_hits)
        g("serve/pool_hits").set(getattr(pager_stats, "pool_hits", 0))
        g("serve/pool_hit_tokens").set(
            getattr(pager_stats, "pool_hit_tokens", 0))

    def serve_pool(self, pool_stats, engine_id=None):
        """Per-step cross-process KV-pool gauges (cheap sets, no event).
        ``pool_stats`` is ``DecodeEngine.pool_stats()``: cumulative
        export/fetch counters plus the current generation — gauges, not
        counters, because the engine owns the cumulative values and
        re-emits them every step (the same pattern as serve_paged)."""
        g = self.registry.gauge
        g("pool/gen").set(pool_stats.get("gen", 0))
        g("pool/exports").set(pool_stats.get("exports", 0))
        g("pool/export_errors").set(pool_stats.get("export_errors", 0))
        g("pool/fetches").set(pool_stats.get("fetches", 0))
        g("pool/fetch_hits").set(pool_stats.get("fetch_hits", 0))
        g("pool/fetch_misses").set(pool_stats.get("fetch_misses", 0))
        g("pool/adopted_blocks").set(pool_stats.get("adopted_blocks", 0))
        g("pool/adopted_tokens").set(pool_stats.get("adopted_tokens", 0))
        g("pool/pending_exports").set(pool_stats.get("pending_exports", 0))
        if engine_id is not None:
            g(f"pool/fetch_hits.eng{engine_id}").set(
                pool_stats.get("fetch_hits", 0))

    def serve_admitted(self, ttft_s: float, bucket: int, prefill_s: float):
        """A request's prefill folded into a free slot; its first token is
        out. ttft_s spans submit -> first token (queue wait included)."""
        self.registry.counter("serve/admissions").inc()
        self.registry.histogram("serve/ttft_s").observe(ttft_s)
        self.registry.histogram("serve/prefill_s").observe(prefill_s)
        self.emit("serve_admit", ttft_s=ttft_s, bucket=bucket,
                  prefill_s=prefill_s)

    def serve_step(self, dur_s: float, live: int, queue_depth: int,
                   engine_id=None):
        """One decode step over all live slots: per-token latency is
        dur_s (the whole batch advances one token per step)."""
        self.registry.counter("serve/decode_steps").inc()
        self.registry.counter("serve/tokens").inc(live)
        self.registry.gauge("serve/live_slots").set(live)
        self.registry.gauge("serve/queue_depth").set(queue_depth)
        self.registry.histogram("serve/step_s").observe(dur_s)
        # goodput: the decode executable ran full-shape over max_slots rows
        # (HFU) while only `live` of them carried requests (MFU) — the
        # ledger scales model FLOPs by the live fraction; decode tokens are
        # GENERATED tokens, the serving-throughput figure
        now = time.perf_counter()
        self.goodput.dispatch("serve", (engine_id, "decode", None),
                              now - dur_s, now, tokens=live,
                              generated=True)

    def serve_spec_step(self, dur_s: float, drafted: int, accepted: int,
                        emitted: int, width: int, drafter: str,
                        live: int = 0, queue_depth: int = 0,
                        accepted_per_step=None, hit_rate=None,
                        engine_id=None):
        """One speculative verify dispatch for one slot: ``drafted`` tokens
        proposed, ``accepted`` of them agreed with the verifier, and
        ``emitted`` tokens actually advanced the request (accepted + the
        bonus token, clipped by eos/budget). Goodput accounting is the
        multi-token mirror of serve_step: the verify executable ran
        ``width`` positions (HFU bills all of them), but only ``emitted``
        tokens are model progress — the ledger's tokens/registered-tokens
        scaling attributes exactly the accepted fraction to MFU, so
        rejected-draft FLOPs can never inflate utilization, and
        serve/tokens_per_s_chip counts ACCEPTED tokens only."""
        c = self.registry.counter
        c("serve/spec_steps").inc()
        c("serve/tokens").inc(emitted)
        if drafted:
            c("serve/spec_drafted").inc(drafted)
            c(f"serve/spec_drafted.{drafter}").inc(drafted)
        if accepted:
            c("serve/spec_accepted").inc(accepted)
            c(f"serve/spec_accepted.{drafter}").inc(accepted)
        c(f"serve/spec_emitted.{drafter}").inc(emitted)
        g = self.registry.gauge
        g("serve/live_slots").set(live)
        g("serve/queue_depth").set(queue_depth)
        if accepted_per_step is not None:
            g("serve/spec_accepted_per_step").set(accepted_per_step)
        if hit_rate is not None:
            g("serve/spec_draft_hit_rate").set(hit_rate)
        self.registry.histogram("serve/spec_step_s").observe(dur_s)
        now = time.perf_counter()
        self.goodput.dispatch("serve", (engine_id, "verify", width),
                              now - dur_s, now, tokens=emitted,
                              generated=True)

    def serve_spec(self, drafter: str, drafted: int, accepted: int,
                   emitted: int, trace_id=None):
        """A speculative request finished: its whole-lifetime draft ledger
        as one event (per-step figures live in the counters above)."""
        fields = dict(drafter=drafter, drafted=int(drafted),
                      accepted=int(accepted), emitted=int(emitted))
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_spec", **fields)

    def serve_prefill_step(self, dur_s: float, bucket, tokens: int,
                           engine_id=None):
        """One prefill execution (a chunk iteration, or a monolithic
        bucketed prefill): productive time + FLOPs for the goodput ledger;
        ``tokens`` is the VALID token count this call carried (a padded
        chunk tail is hardware work but not model work)."""
        now = time.perf_counter()
        self.goodput.dispatch("serve", (engine_id, "prefill", bucket),
                              now - dur_s, now, tokens=tokens)

    def serve_sched(self, t0: float, t1: float):
        """One whole scheduler iteration (``DecodeEngine.step()``) as a
        perf_counter bracket: the executable calls inside it classify as
        productive/compile, the remainder is engine host overhead — which
        makes a serving burst's timeline gap-free."""
        self.goodput.add("overhead", t0, t1)

    def serve_done(self, n_tokens: int, total_s: float, status: str):
        """A request left its slot (stop condition hit)."""
        self.registry.counter("serve/completions").inc()
        self.registry.histogram("serve/request_s").observe(total_s)
        self.registry.histogram("serve/request_tokens").observe(n_tokens)
        self.emit("serve_done", tokens=n_tokens, total_s=total_s,
                  status=status)

    # ------------------------------------------ integration: serving guardrails

    def serve_expired(self, where: str, preemptions: int = 0,
                      tokens: int = 0, trace_id=None):
        """A request's deadline passed at a step boundary (terminal status
        "expired"); ``where`` names the state it died in (queue / prefill /
        decode / drain). ``preemptions > 0`` on expiry events is the
        pool-thrash signature metrics_summary WARNs on: requests are
        losing their deadline budget to eviction-and-recompute churn, so
        raise kv_blocks or lower deadlines. ``trace_id``: the expired
        request's own trace."""
        self.registry.counter("serve/expired").inc()
        fields = dict(where=where, preemptions=int(preemptions),
                      tokens=int(tokens))
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_expire", **fields)

    def serve_cancelled(self, where: str, trace_id=None):
        """engine.cancel() terminalized a request (queue / prefill /
        decode); its slot and blocks are already released."""
        self.registry.counter("serve/cancelled").inc()
        fields = dict(where=where)
        if trace_id:
            fields["trace"] = trace_id
        self.emit("serve_cancel", **fields)

    def serve_drain_begin(self, live: int, queued: int,
                          grace_s: Optional[float]):
        """The engine's door closed (begin_drain): ``live`` slots get the
        grace budget, ``queued`` requests bounce as rejected_draining."""
        self.emit("serve_drain_begin", live=int(live), queued=int(queued),
                  grace_s=grace_s)

    def serve_drain_end(self, wall_s: float):
        """Drain complete: nothing in flight. serve/drained counts drain
        OPERATIONS (per-request outcomes live in completions / expired /
        rejected_draining)."""
        self.registry.counter("serve/drained").inc()
        self.emit("serve_drain_end", wall_s=wall_s)

    def serve_hang(self, kind: str, bucket, elapsed_s: float, hang_s: float,
                   engine_id=None, trace_ids=()):
        """The dispatch watchdog caught a decode/chunk call exceeding
        PADDLE_SERVE_HANG_S — emitted FROM the watchdog thread while the
        dispatch is still stuck, so the evidence outlives a wedged
        process. ``trace_ids``: the live requests' traces (escalated past
        head sampling by the caller)."""
        self.registry.counter("serve/hang_warns").inc()
        self.emit("serve_hang", path=kind, bucket=bucket,
                  elapsed_s=elapsed_s, hang_s=hang_s, engine=engine_id,
                  traces=list(trace_ids))

    # ---------------------------------------------- integration: fleet router

    def route_placed(self, engine, affinity: bool):
        """The router placed one request: ``affinity`` means its prompt's
        first-block digest matched a key the chosen engine advertised
        (cache-aware hit); otherwise it spilled to least-loaded. Counters
        only — placement happens per request, an event per call would
        swamp the sink."""
        if affinity:
            self.registry.counter("route/affinity_hits").inc()
        else:
            self.registry.counter("route/spills").inc()

    def route_reject(self, why: str):
        """No engine could take the request (every door draining/stale or
        the fleet is empty) — the router's own saturation signal."""
        self.registry.counter("route/rejected").inc()
        self.emit("route_reject", why=why)

    def route_queued(self, depth: int):
        """Every live door was at capacity, so the router parked the
        request in its bounded admission queue instead of rejecting it;
        ``depth`` is the queue depth after the push. Saturation that
        resolves itself shows up here, not in route/rejected."""
        self.registry.counter("route/queued").inc()
        self.registry.gauge("route/queue_depth").set(int(depth))

    def route_requeue(self, request_id, from_engine, to_engine,
                      why: str, trace_id=None):
        """A request moved to a different engine (its first engine died or
        bounced it draining). The engine-side id dedup makes this
        idempotent, so a requeue is bookkeeping, never a duplicate
        generation."""
        self.registry.counter("route/requeues").inc()
        fields = dict(request=str(request_id), src=str(from_engine),
                      dst=str(to_engine), why=why)
        if trace_id:
            fields["trace"] = trace_id
        self.emit("route_requeue", **fields)

    def route_eject(self, engine, why: str):
        """The router declared one engine dead (stale heartbeat, transport
        failure past retry, or chaos kill) and removed it from placement;
        only a strictly NEWER incarnation re-admits that name."""
        self.registry.counter("route/ejections").inc()
        self.emit("route_eject", engine=str(engine), why=why)

    def route_state(self, doors, counters):
        """Periodic router fleet view (per-engine door state + router
        counters) — tools/fleet_top.py's router panel renders the latest
        of these."""
        self.emit("route_state", doors=doors, counters=dict(counters))

    # -------------------------------------------------- integration: profiler

    def stage_event(self, name: str, start: float, end: float, kind: str):
        """Mirror of profiler stage/user ranges into the sink, so one JSONL
        carries both the always-on metrics and any traced windows."""
        self.emit("stage", name=name, stage_kind=kind,
                  start=start, end=end, dur_s=end - start)

    # --------------------------------------------------------- memory census

    def memory_census(self, top: int = 10, device: str = "cuda") -> dict:
        census = live_array_census(top, device)
        self.registry.gauge("memory/live_arrays").set(census["count"])
        self.registry.gauge("memory/live_bytes").set(census["total_bytes"])
        self.emit("census", **census)
        return census

    # ---------------------------------------------------------- post-mortems

    def dump(self, path: Optional[str] = None,
             exc: Optional[BaseException] = None) -> str:
        if path is None:
            base = self.sink.path if self.sink is not None \
                else f"monitor_{os.getpid()}.jsonl"
            root, _ = os.path.splitext(base)
            path = root + ".flight.json"
        snap = self._emit_counters()
        self.flush()
        # span-tracer context: the dump names the trace(s) to open, and a
        # crash force-samples everything in flight so they exist on disk
        # rank 0 with the fleet plane up: the crash report says what the
        # FLEET looked like, not just the dying rank
        fleet = None
        try:
            from . import collector as _collector
            fleet = _collector.fleet_state()
        except Exception:
            pass
        trace_info = None
        tracer = _trace_mod._active
        if tracer is not None:
            if exc is not None:
                tracer.escalate(reason="crash")
            trace_info = tracer.snapshot_info()
            tracer.flush()
        return self.flight.dump(path, registry_snapshot=snap, exc=exc,
                                fleet=fleet, trace=trace_info)

    def on_crash(self, exc: BaseException):
        # one dump per exception object: a TrainStep raising inside a caller
        # that also reports would otherwise dump twice. The mark
        # lives ON the exception (not an id() set: a collected exception's id
        # gets reused, which would silently suppress a later real dump)
        if getattr(exc, "_paddle_monitor_dumped", False):
            return
        try:
            exc._paddle_monitor_dumped = True
        except Exception:
            pass  # unmarkable exception: accept a possible double dump
        try:
            path = self.dump(exc=exc)
            self.emit("crash", dump=path, exc_type=type(exc).__name__)
            self.flush()
        except Exception:
            pass  # post-mortem tooling must never mask the real exception


# ------------------------------------------------------------------ module API


def enable(path: Optional[str] = None, *, warn_after: Optional[int] = None,
           flush_every: int = 64, ring: int = 256,
           fleet=None, trace=None) -> Monitor:
    """Turn the monitor on. ``path`` is the JSONL sink file (None: flight
    recorder only); in multi-process runs each process writes
    ``path.procN`` (see sink.resolve_sink_path). Idempotent-safe: enabling
    while enabled closes the previous session first.

    ``fleet`` starts the online fleet-telemetry plane (monitor/collector.py):
    True derives the rank-0 stream path from ``path`` (``run.jsonl`` ->
    ``run.fleet.jsonl``), a string is the explicit stream path. Default None
    follows the ``PADDLE_MONITOR_FLEET`` env.

    ``trace`` starts the span tracer (monitor/trace.py): True derives
    ``run.trace.jsonl`` from ``path`` (per-process suffix applies), a
    string is the explicit path; default None follows ``PADDLE_TRACE``;
    sampling follows ``PADDLE_TRACE_SAMPLE``."""
    global _active
    with _lock:
        if _active is not None:
            _teardown_locked()
        mon = Monitor(path, warn_after=warn_after, flush_every=flush_every,
                      ring=ring)
        _goodput_mod._set_active(mon.goodput)
        _active = mon
        from ..core import dispatch
        dispatch.set_monitor_hooks(mon.op_hook, mon.op_compile_hook)
    if fleet is None:
        v = os.environ.get("PADDLE_MONITOR_FLEET")
        # explicit falsy values DISABLE (an operator's FLEET=0 must not
        # start the plane with a stream file literally named "0")
        fleet = None if not v or v.lower() in ("0", "false", "no", "off") \
            else v
    if fleet:
        from . import collector as _collector
        _collector.start(
            registry=mon.registry, emit=mon.emit,
            fleet_path=_collector.resolve_fleet_path(
                fleet if isinstance(fleet, str) else None, path))
    if trace is None:
        v = os.environ.get("PADDLE_TRACE")
        trace = None if not v or v.lower() in ("0", "false", "no", "off") \
            else v
    if trace:
        if isinstance(trace, str) and trace.lower() not in ("1", "true",
                                                            "yes", "on"):
            tpath = trace
        else:
            base = path or f"monitor_{os.getpid()}.jsonl"
            root, _ = os.path.splitext(base)
            tpath = root + ".trace.jsonl"
        tracer = _trace_mod.enable(tpath)
        tracer._via_monitor = True   # disable() tears it down with us
    return mon


def _teardown_locked():
    global _active
    mon, _active = _active, None
    _goodput_mod._set_active(None)
    from ..core import dispatch
    dispatch.set_monitor_hooks(None, None)
    from . import collector as _collector
    if mon is not None and _collector.get_active() is not None:
        # only the plane over THIS session's registry dies with it
        if _collector.get_active().publisher.registry is mon.registry:
            _collector.stop()
    tracer = _trace_mod.get()
    if mon is not None and tracer is not None \
            and getattr(tracer, "_via_monitor", False):
        # a tracer the user enabled directly outlives the monitor session
        _trace_mod.disable()
    if mon is not None:
        mon.close()


def disable():
    """Flush + close the sink (and a tracer and a fleet plane enabled with
    the monitor)."""
    with _lock:
        _teardown_locked()


def enabled() -> bool:
    return _active is not None


def get() -> Optional[Monitor]:
    return _active


def emit(kind: str, **fields):
    mon = _active
    if mon is not None:
        mon.emit(kind, **fields)


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the flight-recorder post-mortem JSON now (enabled monitor only)."""
    mon = _active
    if mon is None:
        return None
    return mon.dump(path)


def counter(name: str) -> Optional[Counter]:
    mon = _active
    return mon.registry.counter(name) if mon is not None else None


def gauge(name: str) -> Optional[Gauge]:
    mon = _active
    return mon.registry.gauge(name) if mon is not None else None


def histogram(name: str) -> Optional[Histogram]:
    mon = _active
    return mon.registry.histogram(name) if mon is not None else None


def snapshot() -> Optional[dict]:
    mon = _active
    if mon is None:
        return None
    try:
        mon.goodput.refresh()   # idle/fraction current as of THIS snapshot
    except Exception:
        pass
    return mon.registry.snapshot()


def fleet_state() -> Optional[dict]:
    """Rank 0's latest aggregated fleet record when the collector plane is
    up (monitor/collector.py); None on other ranks or when inactive."""
    from . import collector as _collector
    return _collector.fleet_state()


def prom_render(source=None) -> str:
    """Prometheus text-format view of monitor metrics (monitor/prom.py).

    ``source=None`` renders the LIVE registry of the enabled monitor (plus
    the latest fleet record when the collector plane is up — per-rank
    values gain ``rank`` labels); pass a registry ``snapshot()`` dict or a
    fleet record to render those instead. Empty string when nothing is
    enabled."""
    if source is None:
        mon = _active
        if mon is None:
            return ""
        fleet = fleet_state()
        if fleet is not None:
            return _prom.render(fleet)
        # a scrape must see current goodput/idle figures, not the state as
        # of the last hook event
        try:
            mon.goodput.refresh()
        except Exception:
            pass
        source = mon.registry.snapshot()
    return _prom.render(source)


def on_crash(exc: BaseException):
    """Integration-point crash hook (TrainStep's except block)."""
    mon = _active
    if mon is not None:
        mon.on_crash(exc)


def _maybe_enable_from_env():
    """PADDLE_MONITOR=<path|1> opt-in, read once at import. A bad value
    (unparsable warn_after, unwritable path) must degrade to a warning —
    telemetry can never be the reason `import paddle_tpu_torch` fails."""
    v = os.environ.get("PADDLE_MONITOR")
    if not v:
        return
    path = v if v.lower() not in ("1", "true", "yes", "on") \
        else f"monitor_{os.getpid()}.jsonl"
    try:
        wa = os.environ.get("PADDLE_MONITOR_WARN_AFTER")
        enable(path, warn_after=int(wa) if wa else None)
    except Exception as e:
        warnings.warn(f"PADDLE_MONITOR={v!r}: could not enable the monitor "
                      f"({type(e).__name__}: {e}); continuing without "
                      f"telemetry", RuntimeWarning)


@atexit.register
def _atexit_flush():
    mon = _active
    if mon is not None:
        try:
            mon.close()
        except Exception:
            pass
