"""Model-health plane — watch the *numbers* flowing through the step
(counterpart of ``paddle_tpu/monitor/health.py``).

Four channels, as in the JAX package:

* **numerics tripwires** — per leaf group (``leaf_groups``): the count of
  non-finite gradient entries, the largest finite |g| and the finite sum
  of squares, plus the loss's own finite flag. A trip escalates the
  step's trace, WARNs naming the offending groups, sweeps the live
  parameters for the exact poisoned leaves, dumps the flight ring and
  advances the ``health/*`` counters;
* **per-layer tensor stats** — gradient norm, update-to-weight ratio and
  activation RMS at the ``core/remat.py`` tags (attn_qkv, attn_context,
  attn_out, mlp_hidden), gauged on the sample cadence;
* **loss-spike detector** — a rolling median/MAD window with quarantine;
* **weight digests** — a Rademacher projection of the parameters and the
  gradients, hashed elementwise from each leaf's flat index in the JAX
  package's layout, so a port digest equals the JAX digest on the same
  weights (``nn.Linear`` weights, stored ``[out, in]`` here and ``[in,
  out]`` there, are indexed as the JAX package lays them out).

The device half differs from the JAX package's. There the stats are
compiled into the step's executable and ride every step's outputs; the
host pulls them every ``PADDLE_HEALTH_SAMPLE`` steps. The port's step is
eager, so ``DeviceStats`` computes them only on a sampled step, in fp32,
with as few launches as the torch ops allow: the multi-tensor norms
(``torch._foreach_norm``), one flat fp32 copy of the updated leaves before
the update and one after (their difference split back into the leaves
for the update norms, the second also the weights' digest), the digests
as one dot product a probe with probes cached for the session
(``ProbeCache``), and one host read; an unsampled step pays nothing. A
sampled step reads what the JAX host reads at that step. Activation taps
record only on a sampled step too, and are suspended while a recompute
region replays its forward (``suspend_taps``), so a replayed block does
not tap twice; the JAX package suspends them over the whole remat region
(its values there are inner-trace tracers), so under recompute the port
reports activation RMS where the JAX package reports none.

Env surface (the JAX package's): ``PADDLE_HEALTH=0`` opts a monitor
session out; ``PADDLE_HEALTH_SAMPLE`` (default 16) is the sampling
cadence; ``PADDLE_HEALTH_OVERFLOW`` (default 1e8) the |grad| overflow
threshold; ``PADDLE_HEALTH_DIGEST`` (default 2) the probe count (0
disables digests); ``PADDLE_HEALTH_SPIKE_WINDOW``/``_K``/``_MIN`` tune the
spike detector; ``PADDLE_HEALTH_FAULT`` is the chaos seam:
``nan@param:N[:leaf]`` poisons a parameter with NaN before call N,
``scale@param:N[:factor]`` multiplies one to plant a loss spike.
"""
from __future__ import annotations

import math
import os
import threading
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

__all__ = ["HealthPlane", "DeviceStats", "ProbeCache", "SpikeDetector",
           "FaultPlan",
           "collect_taps", "suspend_taps", "active_taps", "probe_salt",
           "leaf_groups", "digest", "DIGEST_STEP_GAUGE", "DIGEST_PREFIX"]

# gauge names the fleet aggregator keys its cross-rank comparison on
DIGEST_STEP_GAUGE = "health/digest_step"
DIGEST_PREFIX = "health/digest/"

# elements of a leaf hashed at once by ``digest`` (bounds its int64
# scratch to 16M x 8 bytes a buffer)
_DIGEST_CHUNK = 1 << 24
# the probe vectors a session keeps (``ProbeCache``): at most this share of
# the device's memory (a fixed 256 MiB on the CPU); past it the probes are
# hashed anew at every sample
_PROBE_CACHE_SHARE = 1 / 32
_PROBE_CACHE_CPU_BYTES = 256 << 20


def probe_salt(leaf_j: int, probe_d: int) -> int:
    """The 32-bit salt seeding leaf ``j``'s probe-``d`` Rademacher vector
    (the JAX package's keying, bit for bit)."""
    return (0x5EED ^ (leaf_j * 0x9E3779B9) ^ (probe_d * 0x85EBCA6B)) \
        & 0xFFFFFFFF


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ------------------------------------------------------------ activation taps
#
# core/remat.py's tag_activation calls active_taps(): when a collector is
# open (a sampled TrainStep call with health on) each named activation adds
# (sum of squares on the device, element count). Thread-local: a serving
# engine on another thread never sees a train step's collector.

_tls = threading.local()


class _TapCollector:
    def __init__(self):
        self.sumsq = {}
        self.count = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        # one launch a tap: the fp32 norm (it upcasts as it reads, no fp32
        # copy of x); the squares and sums wait for the harvest
        with torch.no_grad():
            n = torch.linalg.vector_norm(x.detach(), 2, dtype=torch.float32)
        self.sumsq.setdefault(name, []).append(n)
        self.count[name] = self.count.get(name, 0) + int(x.numel())

    def harvest(self) -> dict:
        """{name: rms} as 0-d device tensors (empty when nothing tapped)."""
        return {n: torch.sqrt(torch.stack(v).square().sum()
                              / max(self.count[n], 1))
                for n, v in self.sumsq.items()}


def active_taps() -> Optional[_TapCollector]:
    if getattr(_tls, "suspended", 0):
        return None
    return getattr(_tls, "taps", None)


def taps_suspended() -> bool:
    """True inside a ``suspend_taps`` block (a recompute region's replay)."""
    return bool(getattr(_tls, "suspended", 0))


class collect_taps:
    """Context manager: collect named-activation stats for one call."""

    def __enter__(self) -> _TapCollector:
        self._prev = getattr(_tls, "taps", None)
        _tls.taps = _TapCollector()
        return _tls.taps

    def __exit__(self, *exc):
        _tls.taps = self._prev
        return False


class suspend_taps:
    """Pause tap collection (and the recompute trace statistics) while a
    recompute region replays its forward in the backward (re-entrant)."""

    def __enter__(self):
        _tls.suspended = getattr(_tls, "suspended", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.suspended -= 1
        return False


# ------------------------------------------------------------- leaf grouping


def leaf_groups(names):
    """Group trainable-leaf names by module (name minus its last component:
    ``h.3.attn.qkv_proj.weight`` → ``h.3.attn.qkv_proj``). Returns (group
    names, per-leaf index)."""
    groups, group_of, index = [], [], {}
    for n in names:
        g = n.rsplit(".", 1)[0] if "." in n else n
        if g not in index:
            index[g] = len(groups)
            groups.append(g)
        group_of.append(index[g])
    return groups, group_of


# ------------------------------------------------------------------- digests


def _hash_sign(idx: torch.Tensor, salt: int) -> torch.Tensor:
    """±1 (fp32) of the murmur3 finalizer of the uint32 ``idx ^ salt``,
    the JAX package's probe. uint32 arithmetic in int64: every product is
    masked back to 32 bits (the low 64 bits of an int64 product wrap
    exactly, so the low 32 are the uint32 product's)."""
    m = 0xFFFFFFFF
    x = idx ^ salt
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & m
    x = ((x ^ (x >> 15)) * 0x846CA68B) & m
    x = x ^ (x >> 16)
    return 1.0 - 2.0 * (x & 1).to(torch.float32)


def _jax_index(shape, transposed: bool, s: int, e: int, device):
    """The JAX-layout flat index of elements ``s .. e-1`` of a leaf in its
    torch memory order: the position itself, or for a ``transposed`` ``[out,
    in]`` weight, element (o, i)'s JAX index ``i * out + o``."""
    pos = torch.arange(s, e, dtype=torch.int64, device=device)
    if not (transposed and len(shape) == 2):
        return pos
    out_f, in_f = shape
    return (pos % in_f) * out_f + pos // in_f


def _leaf_dot(x: torch.Tensor, j: int, d: int, transposed: bool):
    """<x, r(j, d)> in fp32 over x's flat index in the JAX layout (a
    ``transposed`` leaf is a ``[out, in]`` weight), hashed in chunks."""
    salt = probe_salt(j, d)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    flat = x.reshape(-1)
    n = flat.numel()
    for s in range(0, n, _DIGEST_CHUNK):
        e = min(s + _DIGEST_CHUNK, n)
        idx = _jax_index(tuple(x.shape), transposed, s, e, x.device)
        acc = acc + torch.dot(flat[s:e].float(), _hash_sign(idx, salt))
    return acc


def _flat32(leaves) -> torch.Tensor:
    """The leaves concatenated, flat, in fp32 (one copy)."""
    return torch.cat([x.detach().reshape(-1).float() for x in leaves])


class ProbeCache:
    """The probe vectors of one session's leaves, concatenated in the
    leaves' order: ``[n_probes, total elements]`` fp32 ±1, each leaf's in
    its memory order. Built at the first sample and reused: a sample then
    takes one dot product a probe with the concatenated leaves — a few
    launches for all of them, where hashing (or a product) a leaf would
    launch hundreds of small kernels at the tail of the step, which the
    host then paces. Bounded by ``_PROBE_CACHE_SHARE`` of the device's
    memory; past the bound the leaves are hashed at every sample
    (``_leaf_dot``)."""

    def __init__(self):
        self._probes = {}
        self._bytes = 0

    def _budget(self, device) -> int:
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            return int(total * _PROBE_CACHE_SHARE)
        return _PROBE_CACHE_CPU_BYTES

    def probes(self, leaves, n_probes: int,
               transposed) -> Optional[torch.Tensor]:
        dev = leaves[0].device
        key = (n_probes, dev, tuple((tuple(x.shape), bool(t))
                                    for x, t in zip(leaves, transposed)))
        r = self._probes.get(key)
        if r is not None:
            return r
        n = sum(x.numel() for x in leaves)
        if self._bytes + 4 * n_probes * n > self._budget(dev):
            return None
        r = torch.empty(n_probes, n, dtype=torch.float32, device=dev)
        off = 0
        for j, (x, t) in enumerate(zip(leaves, transposed)):
            idx = _jax_index(tuple(x.shape), bool(t), 0, x.numel(), dev)
            for d in range(n_probes):
                r[d, off:off + x.numel()] = _hash_sign(idx, probe_salt(j, d))
            off += x.numel()
        self._probes[key] = r
        self._bytes += 4 * n_probes * n
        return r

    def digest(self, leaves, n_probes: int, transposed,
               flat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``digest``'s value, from the cached probes when they fit
        (``flat``: the leaves already concatenated by ``_flat32``)."""
        transposed = [bool(t) for t in transposed]
        r = self.probes(leaves, n_probes, transposed)
        if r is None:
            return digest(leaves, n_probes, transposed)
        flat = _flat32(leaves) if flat is None else flat
        return torch.stack([torch.dot(r[d], flat) for d in range(n_probes)])


def digest(leaves, n_probes: int, transposed=None) -> torch.Tensor:
    """``[n_probes]`` fp32 digest: per probe d, the sum over leaves j of
    ``<leaf_j, r(j, d)>`` where r is the ±1 Rademacher vector hashed from
    the flat index (``probe_salt``). ``transposed[j]`` marks a leaf held
    transposed from the JAX layout (an ``nn.Linear`` weight)."""
    out = []
    for d in range(n_probes):
        acc = None
        for j, x in enumerate(leaves):
            v = _leaf_dot(x, j, d, bool(transposed and transposed[j]))
            acc = v if acc is None else acc + v
        out.append(acc)
    return torch.stack(out)


# ------------------------------------------------------------ device stats


class DeviceStats:
    """The device half of one sampled step (counterpart of the JAX
    package's ``CompiledHealth``): per-leaf reductions launched as the
    step runs, grouped and checked on the host after one read.

    ``names`` are the trainable leaves' names in update order, and
    ``transposed`` flags the leaves the digest indexes transposed."""

    # stat layout columns of the host payload's "grad" block
    GRAD_NONFINITE, GRAD_MAXABS, GRAD_SUMSQ = 0, 1, 2

    def __init__(self, plane: "HealthPlane", names, transposed=None,
                 probes: Optional[ProbeCache] = None):
        self.plane = plane
        self.probes = probes
        self.groups, self.group_of = leaf_groups(names)
        self.names = list(names)
        self.transposed = list(transposed) if transposed is not None \
            else [False] * len(self.names)
        self.n_probes = plane.digest_probes
        self._parts = {}
        self._old = None

    # ------------------------------------------------------------ launches

    def grads(self, grads):
        """Per-leaf max |g| and sum of squares, fp32, before the clip."""
        if not grads:
            return
        self._grads = list(grads)
        self._parts["gmax"] = torch.stack(torch._foreach_norm(
            grads, float("inf"), dtype=torch.float32))
        self._parts["gnorm"] = torch.stack(torch._foreach_norm(
            grads, 2, dtype=torch.float32))

    def before_update(self, upd):
        """Snapshot the leaves the update rule writes (the fp32 masters
        where they exist): their norms, and one flat fp32 copy for the
        delta."""
        self._upd = list(upd)
        self._parts["wnorm"] = torch.stack(torch._foreach_norm(
            self._upd, 2, dtype=torch.float32))
        self._old = _flat32(self._upd)

    def after_update(self):
        """||new - old|| per leaf (the copy is overwritten in place by the
        difference, split back into the leaves), and the digests of the
        updated leaves (from the same flat copy) and of the gradients."""
        new = _flat32(self._upd)
        if self.n_probes > 0:
            if self.probes is None:
                self._parts["pdig"] = digest(self._upd, self.n_probes,
                                             self.transposed)
                self._parts["gdig"] = digest(self._grads, self.n_probes,
                                             self.transposed)
            else:
                self._parts["pdig"] = self.probes.digest(
                    self._upd, self.n_probes, self.transposed, flat=new)
                self._parts["gdig"] = self.probes.digest(
                    self._grads, self.n_probes, self.transposed)
        diff = self._old.sub_(new)
        self._parts["dnorm"] = torch.stack(torch._foreach_norm(
            list(diff.split([u.numel() for u in self._upd])), 2))
        self._old = None

    # --------------------------------------------------------------- host

    def read(self, loss: torch.Tensor, act: Optional[dict] = None) -> dict:
        """The one host read: every part stacked into one fp32 vector,
        copied once, then split and grouped into the JAX host payload
        (``loss2`` [2], ``grad`` [G, 3], ``ratio`` [G, 2], ``pdig``/``gdig``
        [D], ``act`` {name: rms}) and the loss itself (``loss``)."""
        act = act or {}
        lf = loss.detach().float().reshape(1)
        keys = [k for k in ("gmax", "gnorm", "wnorm", "dnorm", "pdig",
                            "gdig") if k in self._parts]
        flat = torch.cat([lf] + [self._parts[k].reshape(-1) for k in keys]
                         + [torch.stack(list(act.values()))
                            if act else lf[:0]]).cpu().numpy() \
            .astype(np.float64)
        got, off = {}, 1
        for k in keys:
            n = self._parts[k].numel()
            got[k] = flat[off:off + n]
            off += n
        act_host = dict(zip(act, flat[off:].tolist()))
        loss_v = flat[0]
        if not math.isfinite(loss_v) or not np.isfinite(
                np.concatenate([got.get("gmax", []), got.get("gnorm", [])])
        ).all():
            # a tripped step: the fused norms carry the NaN/Inf; recount
            # per leaf as the JAX package does (non-finite entries out of
            # the max and the sum of squares) — one more read, trips only
            got.update(self._exact_grad_parts())
        G = len(self.groups)
        grad = np.zeros((G, 3))
        ratio = np.zeros((G, 2))
        for i, gi in enumerate(self.group_of):
            if "gmax" in got:
                grad[gi, 0] += got.get("gnf", np.zeros(len(self.names)))[i]
                grad[gi, 1] = max(grad[gi, 1], got["gmax"][i])
                grad[gi, 2] += got["gnorm"][i] ** 2 \
                    if "gsumsq" not in got else got["gsumsq"][i]
            if "dnorm" in got:
                ratio[gi, 0] += got["dnorm"][i] ** 2
                ratio[gi, 1] += got["wnorm"][i] ** 2
        out = {"loss2": np.array([0.0 if math.isfinite(loss_v) else 1.0,
                                  abs(loss_v) if math.isfinite(loss_v)
                                  else 0.0]),
               "grad": grad, "ratio": ratio, "loss": float(loss_v)}
        if "pdig" in got:
            out["pdig"], out["gdig"] = got["pdig"], got["gdig"]
        if act_host:
            out["act"] = act_host
        self._parts = {}
        self._grads = self._upd = None
        return out

    def _exact_grad_parts(self) -> dict:
        nf, mx, ss = [], [], []
        for g in self._grads:
            gf = g.detach().float()
            fin = torch.isfinite(gf)
            a = torch.where(fin, gf.abs(), torch.zeros_like(gf))
            nf.append(gf.numel() - fin.sum())
            mx.append(a.max() if gf.numel() else a.sum())
            ss.append(torch.sum(a * a))
        host = torch.stack([torch.stack(nf).float(), torch.stack(mx),
                            torch.stack(ss)]).cpu().numpy() \
            .astype(np.float64)
        return {"gnf": host[0], "gmax": host[1], "gsumsq": host[2]}


# ------------------------------------------------------------ spike detector


class SpikeDetector:
    """Rolling median/MAD outlier test with quarantine semantics: a value
    flagged as a spike is NEVER appended to the window."""

    def __init__(self, window: int = 32, k: float = 10.0, min_fill: int = 8):
        self.window = max(int(window), 4)
        self.k = float(k)
        self.min_fill = max(int(min_fill), 2)
        self.vals = deque(maxlen=self.window)

    def observe(self, loss: float) -> Optional[dict]:
        """Feed one loss; returns a spike-info dict or None."""
        loss = float(loss)
        if not math.isfinite(loss):
            return {"loss": loss, "median": None, "mad": None,
                    "nonfinite": True}
        if len(self.vals) >= self.min_fill:
            s = sorted(self.vals)
            med = s[len(s) // 2]
            mad = sorted(abs(v - med) for v in s)[len(s) // 2]
            floor = 1e-8 * max(abs(med), 1.0)
            if abs(loss - med) > self.k * max(mad, floor):
                return {"loss": loss, "median": med, "mad": mad,
                        "nonfinite": False}
        self.vals.append(loss)
        return None

    def reset(self):
        self.vals.clear()


# ----------------------------------------------------------------- chaos seam


class FaultPlan:
    """PADDLE_HEALTH_FAULT: deterministic host-side numerics faults.
    Schedule syntax ``<action>@<site>:<nth>[:<arg>]``, comma-separated:

    * ``nan@param:N[:leaf]`` — before TrainStep call N (1-based), write a
      NaN into element 0 of the first trainable parameter (or the first
      whose name contains ``leaf``), in place: the fp32 master, where the
      optimizer keeps one, stays clean, as in the JAX package;
    * ``scale@param:N[:factor]`` — multiply that parameter by ``factor``
      (default 64): a finite perturbation that plants a loss SPIKE."""

    def __init__(self, entries):
        self.entries = entries          # [(action, nth, arg)]
        self.calls = 0
        self.fired = []

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        if not spec:
            return None
        entries = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                action, rest = part.split("@", 1)
                site, nth, *arg = rest.split(":")
                if site != "param" or action not in ("nan", "scale"):
                    raise ValueError(part)
                entries.append((action, int(nth), arg[0] if arg else None))
            except (ValueError, IndexError):
                warnings.warn(f"PADDLE_HEALTH_FAULT: unparsable entry "
                              f"{part!r} (want <nan|scale>@param:<nth>"
                              f"[:<arg>]); ignoring it", RuntimeWarning)
        return cls(entries) if entries else None

    def maybe_fire(self, named_params, emit=None) -> None:
        """Called once per TrainStep call with [(name, Parameter)]."""
        self.calls += 1
        for action, nth, arg in self.entries:
            if nth != self.calls:
                continue
            self._fire(action, arg, named_params, emit)

    def _fire(self, action, arg, named_params, emit):
        target = None
        for n, p in named_params:
            if not p.requires_grad:
                continue
            if action == "nan" and arg and arg not in n:
                continue
            target = (n, p)
            break
        if target is None:
            return
        n, p = target
        with torch.no_grad():
            if action == "nan":
                p.view(-1)[0] = float("nan")
            else:
                p.mul_(float(arg) if arg else 64.0)
        self.fired.append((self.calls, action, n))
        if emit is not None:
            emit("health_fault", call=self.calls, action=action, leaf=n)


# ------------------------------------------------------------------ the plane


class HealthPlane:
    """One monitor session's health state: config, spike detector, trip
    bookkeeping, and the host half of the sampled check. Created by
    ``Monitor.__init__`` unless PADDLE_HEALTH opts out, consulted by
    ``TrainStep`` on the sample cadence."""

    def __init__(self, monitor):
        self.monitor = monitor
        v = os.environ.get("PADDLE_HEALTH", "")
        self.enabled = not (v and v.lower() in ("0", "false", "no", "off"))
        self.sample_every = max(_env_int("PADDLE_HEALTH_SAMPLE", 16), 1)
        self.overflow = _env_float("PADDLE_HEALTH_OVERFLOW", 1e8)
        self.digest_probes = max(_env_int("PADDLE_HEALTH_DIGEST", 2), 0)
        self.spike = SpikeDetector(
            window=_env_int("PADDLE_HEALTH_SPIKE_WINDOW", 32),
            k=_env_float("PADDLE_HEALTH_SPIKE_K", 10.0),
            min_fill=_env_int("PADDLE_HEALTH_SPIKE_MIN", 8))
        self.fault = FaultPlan.parse(os.environ.get("PADDLE_HEALTH_FAULT"))
        self.rollback_hook = None     # callable(step, info) — opt-in
        self.nan_trips = 0
        self.overflow_trips = 0
        self.spikes = 0
        self._dumps = 0
        self._max_dumps = 3
        self._probes = ProbeCache()

    # ---------------------------------------------------------- device side

    def device_stats(self, names, transposed=None) -> Optional[DeviceStats]:
        """The sampled step's device half; None when health is off."""
        if not self.enabled:
            return None
        return DeviceStats(self, names, transposed, self._probes)

    # ------------------------------------------------------------- host side

    def should_sample(self, step_n: int) -> bool:
        return self.enabled and step_n % self.sample_every == 0

    def on_sample(self, spec: DeviceStats, step_n: int, loss_val: float,
                  payload: dict, named_params=None, trace=None) -> dict:
        """One sampled host check: gauges, tripwires, spike feed, digest
        publication. ``payload`` is ``DeviceStats.read``'s. Returns {"nan":
        …, "overflow": …, "spike": …} describing what tripped."""
        reg = self.monitor.registry
        g = reg.gauge
        groups = spec.groups
        grad = np.asarray(payload["grad"], np.float64)
        ratio = np.asarray(payload["ratio"], np.float64)
        loss2 = np.asarray(payload["loss2"], np.float64)

        g("health/sample_every").set(self.sample_every)
        g("health/groups").set(len(groups))
        g("health/loss").set(float(loss_val)
                             if math.isfinite(float(loss_val)) else -1.0)
        for i, name in enumerate(groups):
            g(f"health/grad_norm.{name}").set(math.sqrt(max(grad[i, 2], 0)))
            g(f"health/grad_max.{name}").set(grad[i, 1])
            wn = math.sqrt(max(ratio[i, 1], 0.0))
            un = math.sqrt(max(ratio[i, 0], 0.0))
            g(f"health/update_ratio.{name}").set(un / wn if wn > 0 else 0.0)
        for name, rms in (payload.get("act") or {}).items():
            g(f"health/act_rms.{name}").set(float(np.asarray(rms)))
        if "pdig" in payload:
            g(DIGEST_STEP_GAUGE).set(step_n)
            for d, v in enumerate(np.asarray(payload["pdig"], np.float64)):
                g(f"{DIGEST_PREFIX}p{d}").set(float(v))
            for d, v in enumerate(np.asarray(payload["gdig"], np.float64)):
                g(f"{DIGEST_PREFIX}g{d}").set(float(v))

        nan_groups = [groups[i] for i in np.nonzero(grad[:, 0] > 0)[0]]
        loss_bad = loss2[0] > 0
        over_groups = [groups[i]
                       for i in np.nonzero(grad[:, 1] > self.overflow)[0]]
        out = {"nan": None, "overflow": None, "spike": None}
        if nan_groups or loss_bad:
            out["nan"] = self._trip_nan(step_n, nan_groups, loss_bad,
                                        loss_val, named_params, trace)
        elif over_groups:
            out["overflow"] = self._trip_overflow(step_n, over_groups,
                                                  float(grad[:, 1].max()),
                                                  trace)
        if not loss_bad:
            sp = self.spike.observe(loss_val)
            if sp is not None:
                out["spike"] = self.spike_tripped(step_n, sp,
                                                  source="train_step",
                                                  trace=trace)
        return out

    # ------------------------------------------------------------- tripwires

    def sweep_leaves(self, named_params, limit: int = 8):
        """Follow-up sweep for EXACT attribution: which live leaves hold
        non-finite values right now (one count each, paid only on a
        trip)."""
        bad = []
        for n, p in named_params or ():
            try:
                k = int(p.numel() - torch.isfinite(p.detach()).sum())
            except Exception:
                continue
            if k:
                bad.append({"leaf": n, "nonfinite": k})
                if len(bad) >= limit:
                    break
        return bad

    def _flight_dump(self):
        if self._dumps >= self._max_dumps:
            return None
        self._dumps += 1
        try:
            return self.monitor.dump()
        except Exception:
            return None

    def _escalate(self, reason: str):
        from . import trace as _trace_mod
        tracer = _trace_mod._active
        if tracer is not None:
            tracer.escalate(reason=reason)
            return tracer.current_trace_id()
        return None

    def _trip_nan(self, step_n, groups, loss_bad, loss_val, named_params,
                  trace):
        self.nan_trips += 1
        mon = self.monitor
        mon.registry.counter("health/nan_trips").inc()
        for name in groups:
            mon.registry.counter(f"health/nan_trips.{name}").inc()
        tid = trace or self._escalate("health_nan")
        leaves = self.sweep_leaves(named_params)
        dump = self._flight_dump()
        info = dict(step=step_n, groups=groups, loss_nonfinite=bool(loss_bad),
                    loss=float(loss_val), leaves=leaves, dump=dump)
        mon.emit("health_nan", **({"trace": tid, **info} if tid else info))
        where = ", ".join(groups) if groups else "forward loss"
        warnings.warn(
            f"health: non-finite values at step {step_n} in [{where}]"
            + (f"; poisoned leaves: "
               f"{[b['leaf'] for b in leaves]}" if leaves else "")
            + (f" [trace {tid}]" if tid else "")
            + " — see the health_nan event / flight dump for the sweep",
            RuntimeWarning, stacklevel=3)
        return info

    def _trip_overflow(self, step_n, groups, max_abs, trace):
        self.overflow_trips += 1
        mon = self.monitor
        mon.registry.counter("health/overflow_trips").inc()
        tid = trace or self._escalate("health_overflow")
        info = dict(step=step_n, groups=groups, max_abs=max_abs,
                    threshold=self.overflow)
        mon.emit("health_overflow",
                 **({"trace": tid, **info} if tid else info))
        warnings.warn(
            f"health: |grad| {max_abs:.3e} exceeds the overflow threshold "
            f"{self.overflow:.1e} at step {step_n} in [{', '.join(groups)}]"
            + (f" [trace {tid}]" if tid else ""),
            RuntimeWarning, stacklevel=3)
        return info

    def spike_tripped(self, step_n, sp: dict, source: str, trace=None):
        """A loss spike was detected. Emits + counts, then runs the opt-in
        rollback hook."""
        self.spikes += 1
        mon = self.monitor
        mon.registry.counter("health/spikes").inc()
        tid = trace or self._escalate("health_spike")
        info = dict(step=step_n, source=source, **sp)
        mon.emit("health_spike", **({"trace": tid, **info} if tid else info))
        med = sp.get("median")
        warnings.warn(
            f"health: loss spike at step {step_n}: {sp['loss']:.6g}"
            + (f" vs rolling median {med:.6g} (mad {sp['mad']:.3g})"
               if med is not None else " (non-finite)")
            + (f" [trace {tid}]" if tid else ""),
            RuntimeWarning, stacklevel=3)
        hook, self_info = self.rollback_hook, info
        if hook is not None:
            try:
                res = hook(step_n, info)
            except Exception as e:
                warnings.warn(f"health: rollback_on_spike hook failed "
                              f"({type(e).__name__}: {e}); training "
                              f"continues un-rolled-back", RuntimeWarning)
                res = None
            if res is not None:
                mon.registry.counter("health/rollbacks").inc()
                mon.emit("health_rollback", spike_step=step_n,
                         restored_step=res.get("step")
                         if isinstance(res, dict) else None)
                self.spike.reset()
                self_info["rollback"] = res if isinstance(res, dict) \
                    else {"restored": True}
        return self_info

    def scaler_outcome(self, found_inf: bool, scale: float):
        """amp.GradScaler feed: the loss-scale trajectory next to the trip
        timeline."""
        reg = self.monitor.registry
        reg.gauge("health/loss_scale").set(float(scale))
        if found_inf:
            reg.counter("health/found_inf").inc()
