"""Prometheus text-format rendering of monitor metrics.

A copy of ``paddle_tpu/monitor/prom.py``. Pure stdlib, NO package
imports: ``tools/fleet_prom.py`` loads that module by file path so a
scrape endpoint never has to import a framework just to re-serialize
JSON that is already on disk; this copy renders the port's live registry
the same way. Inputs are plain dicts:

* a registry ``snapshot()`` — ``{"counters": {...}, "gauges": {...},
  "histograms": {...}}`` (one process's view; optional constant labels);
* a fleet record (``kind == "fleet"`` from ``run.fleet.jsonl``) — per-rank
  values become ``rank="<r>"`` labels, fleet-derived gauges render plain.

The goodput/MFU accounting plane (monitor/goodput.py) exports through the
same paths: ``goodput/fraction`` -> ``paddle_goodput_fraction``,
``mfu/hfu`` -> ``paddle_mfu_hfu`` and the per-rank fleet view carries
``paddle_fleet_goodput`` (pod goodput = min over ranks) — the live
registry render freshens the ledger first, so a scrape never reads a
stale idle figure.

Naming follows the Prometheus conventions the exposition format expects:
metric paths are sanitized (``train_step/dispatch_s`` ->
``paddle_train_step_dispatch_s``), counters gain ``_total``, histogram
summaries render as ``<name>{quantile="0.5"}`` plus ``_count``/``_sum``
(summary type — the registry keeps quantile estimates, not raw buckets).
"""
from __future__ import annotations

import re

__all__ = ["render", "render_snapshot", "render_fleet", "sanitize"]

_BAD = re.compile(r"[^a-zA-Z0-9_:]")

# HELP text for the families a dashboard needs explained at the endpoint —
# the model-health plane especially, whose numbers are meaningless without
# units/semantics. Keyed by RAW metric path; per-layer-group suffixes
# (``health/grad_norm.h.0.attn``) match their family via the ``.`` split,
# digest probes (``health/digest/p0``) via prefix. Unknown families render
# without HELP, exactly as before.
_HELP = {
    "health/nan_trips": "sampled steps whose loss or grads held NaN/Inf",
    "health/overflow_trips":
        "sampled steps with |grad| over PADDLE_HEALTH_OVERFLOW",
    "health/spikes": "loss spikes vs the rolling median/MAD window",
    "health/rollbacks": "spike rollbacks that restored a prior snapshot",
    "health/found_inf": "GradScaler-skipped updates (non-finite grads)",
    "health/loss": "last sampled loss (-1 when non-finite)",
    "health/loss_scale": "current AMP dynamic loss scale",
    "health/grad_norm": "per-layer-group gradient L2 norm (sampled)",
    "health/grad_max": "per-layer-group max |grad| over finite entries",
    "health/update_ratio": "per-layer-group update-to-weight norm ratio",
    "health/act_rms": "activation RMS at remat-tagged points (sampled)",
    "health/digest_step": "train step of the published weight digest",
    "health/digest/": "Rademacher-projection weight/grad digest probe "
                      "(cross-rank divergence comparison)",
    "serve/nan_logits": "requests terminalized for non-finite logits",
    "fleet/weight_divergence":
        "1 while one rank's weight digest disagrees with its siblings",
    "fleet/weight_diverged_rank": "the rank whose weight digest forked",
}


def _help_for(raw: str):
    fam = raw.split(".", 1)[0]
    h = _HELP.get(raw) or _HELP.get(fam)
    if h is None:
        for k, v in _HELP.items():
            if k.endswith("/") and raw.startswith(k):
                return v
    return h


def sanitize(name: str, prefix: str = "paddle") -> str:
    n = _BAD.sub("_", name.strip("/"))
    if prefix:
        n = f"{prefix}_{n}"
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return n


def _labels(d: dict) -> str:
    if not d:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(d.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _head(raw: str, name: str, typ: str, out: list):
    h = _help_for(raw)
    if h:
        out.append(f"# HELP {name} {h}")
    out.append(f"# TYPE {name} {typ}")


def _hist_lines(name: str, h: dict, labels: dict, out: list):
    """One histogram summary -> quantile + _sum/_count lines."""
    for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        if key in h:
            out.append(f"{name}{_labels(dict(labels, quantile=q))} "
                       f"{_num(h[key])}")
    out.append(f"{name}_sum{_labels(labels)} {_num(h.get('sum', 0.0))}")
    out.append(f"{name}_count{_labels(labels)} {_num(h.get('count', 0))}")


def render_snapshot(snap: dict, labels: dict = None,
                    prefix: str = "paddle") -> str:
    """A registry ``snapshot()`` dict -> exposition text."""
    labels = dict(labels or {})
    out = []
    for raw, v in sorted((snap.get("counters") or {}).items()):
        name = sanitize(raw, prefix) + "_total"
        _head(raw, name, "counter", out)
        out.append(f"{name}{_labels(labels)} {_num(v)}")
    for raw, v in sorted((snap.get("gauges") or {}).items()):
        name = sanitize(raw, prefix)
        _head(raw, name, "gauge", out)
        out.append(f"{name}{_labels(labels)} {_num(v)}")
    for raw, h in sorted((snap.get("histograms") or {}).items()):
        if not isinstance(h, dict):
            continue
        name = sanitize(raw, prefix)
        _head(raw, name, "summary", out)
        _hist_lines(name, h, labels, out)
    return "\n".join(out) + ("\n" if out else "")


def render_fleet(rec: dict, prefix: str = "paddle") -> str:
    """One fleet record (collector schema v2) -> exposition text with
    ``rank`` labels on every per-rank series plus the fleet-derived
    gauges (step skew, liveness) and a staleness flag per rank."""
    out = []
    metrics = rec.get("metrics") or {}
    for raw, m in sorted((metrics.get("counters") or {}).items()):
        name = sanitize(raw, prefix) + "_total"
        _head(raw, name, "counter", out)
        for r, v in sorted((m.get("per_rank") or {}).items(),
                           key=lambda kv: int(kv[0])):
            out.append(f"{name}{_labels({'rank': r})} {_num(v)}")
    for raw, m in sorted((metrics.get("gauges") or {}).items()):
        name = sanitize(raw, prefix)
        _head(raw, name, "gauge", out)
        for r, v in sorted((m.get("per_rank") or {}).items(),
                           key=lambda kv: int(kv[0])):
            out.append(f"{name}{_labels({'rank': r})} {_num(v)}")
    for raw, m in sorted((metrics.get("histograms") or {}).items()):
        name = sanitize(raw, prefix)
        _head(raw, name, "summary", out)
        per = m.get("per_rank") or {}
        if per:
            for r, h in sorted(per.items(), key=lambda kv: int(kv[0])):
                _hist_lines(name, h, {"rank": r}, out)
        else:
            _hist_lines(name, m, {}, out)
    for raw, v in sorted((rec.get("derived") or {}).items()):
        name = sanitize(raw, prefix)
        _head(raw, name, "gauge", out)
        out.append(f"{name} {_num(v)}")
    stale = set(rec.get("stale") or [])
    ranks = rec.get("ranks") or []
    if ranks:
        name = sanitize("fleet/rank_stale", prefix)
        out.append(f"# TYPE {name} gauge")
        for r in sorted(set(ranks) | stale):
            out.append(f"{name}{_labels({'rank': str(r)})} "
                       f"{1 if r in stale else 0}")
    return "\n".join(out) + ("\n" if out else "")


def render(source: dict, prefix: str = "paddle") -> str:
    """Dispatch on shape: a fleet record renders per-rank, anything else is
    treated as a registry snapshot."""
    if isinstance(source, dict) and source.get("kind") == "fleet":
        return render_fleet(source, prefix=prefix)
    return render_snapshot(source or {}, prefix=prefix)
