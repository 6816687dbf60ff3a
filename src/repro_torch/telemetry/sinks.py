"""Host-side telemetry extraction and sinks (port of
``repro/telemetry/sinks.py``).

After every optimizer step the (post-update) quant state carries that
step's aggregated health counters in its telemetry slots.
:func:`collect` copies the whole quant tree to the host in one transfer
(its leaves flattened and concatenated on the device) and splits it into
per-site records; the sinks persist them:

  * :class:`JsonlSink` — append-only JSONL file with a bounded ring: one
    line per step, compacted in place so the file never holds more than
    ``2 * max_steps`` lines.
  * :class:`MemorySink` — in-process per-site aggregator.

The JSONL schema is the reference's, version 2 (version-less lines are
v1 and still parse):

    {"v": 2, "step": <int>, "sites": {"<site path>": {
        "qmin": f, "qmax": f, "inited": 0|1,
        "clipped": f, "n": f, "clip_rate": f,
        "sqnr_db": f, "util": f, "drift": f, "streak": f}},
     "events": [{"site": s, "step": i, "action":
                 "widen"|"fallback_enter"|"fallback_exit",
                 "old": [qmin, qmax], "new": [qmin, qmax],
                 "clip_rate": f, "streak": f}, ...],
     "perf": {"step_time_ms": f, "phases_ms": {...}, "compile_count": i,
              "throughput": f, "throughput_unit": "tokens/s"|"images/s"}}

Site paths are the reference's: given the model config, the port's
per-layer ``decoder/layers/<i>/...`` (and ``encoder/layers/<i>/...``)
leaves are named as the reference's scanned ``decoder/blocks/b<j>/...[r]``
rows (``decoder/tail/t<k>/...``
for unrolled layers), so logs of the two packages compare site by site
and either package's ``report`` reads both.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import (
    INITED,
    QMAX,
    QMIN,
    T_CLIP,
    T_DRIFT,
    T_ERR,
    T_N,
    T_SIG,
    T_STREAK,
    T_UTIL,
)

_EPS = 1e-12

#: Current JSONL line schema version (the reference's).
SCHEMA_VERSION = 2


def _flatten(tree, path: tuple = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def site_name(path: tuple, cfg=None) -> str:
    """The reference's record name of the port's leaf at ``path``: with
    ``cfg``, layer ``i`` of ``decoder/layers`` (``encoder/layers`` of
    the enc-dec family, by ``cfg.enc_pattern`` and ``cfg.enc_layers``) is
    row ``r`` of the scanned block ``b<j>`` (``i = r * len(pattern) + j``)
    or unrolled tail layer ``t<k>``, as ``repro_torch.convert`` stacks
    them."""
    stacks = {"decoder": (cfg.pattern, cfg.n_layers)} if cfg else {}
    if cfg is not None and cfg.family == "encdec":
        stacks["encoder"] = (cfg.enc_pattern, cfg.enc_layers)
    if len(path) > 3 and path[0] in stacks and path[1] == "layers":
        pattern, n_layers = stacks[path[0]]
        u = len(pattern)
        repeats = n_layers // u
        r, j = divmod(path[2], u)
        rest = "/".join(map(str, path[3:]))
        if r < repeats:
            return f"{path[0]}/blocks/b{j}/{rest}[{r}]"
        return f"{path[0]}/tail/t{path[2] - repeats * u}/{rest}"
    return "/".join(map(str, path))


def _row_record(row: np.ndarray) -> Dict[str, float]:
    rec = {"qmin": float(row[QMIN]), "qmax": float(row[QMAX]),
           "inited": float(row[INITED])}
    if row.shape[-1] > INITED + 1:
        n = max(float(row[T_N]), 1.0)
        sig = max(float(row[T_SIG]), _EPS)
        err = max(float(row[T_ERR]), _EPS)
        rec.update({
            "clipped": float(row[T_CLIP]),
            "n": float(row[T_N]),
            "clip_rate": float(row[T_CLIP]) / n,
            "sqnr_db": min(10.0 * math.log10(sig / err), 99.0),
            "util": float(row[T_UTIL]),
            "drift": float(row[T_DRIFT]),
            "streak": float(row[T_STREAK]),
        })
    return rec


def collect(quant_state, skip_unvisited: bool = True,
            cfg=None) -> Dict[str, Dict[str, float]]:
    """One host transfer of the quant state -> per-site records.

    Works on the post-step state tree (EMA ranges + this step's counters)
    and equally on a forward stats tree (serving).  ``skip_unvisited``
    drops sites whose inited/visited flag is 0.  ``cfg`` (the model
    config) names decoder layers as the reference does
    (:func:`site_name`)."""
    flat = list(_flatten(quant_state))
    if not flat:
        return {}
    host = torch.cat([leaf.detach().reshape(-1).to(torch.float32)
                      for _, leaf in flat]).cpu().numpy()
    out: Dict[str, Dict[str, float]] = {}
    off = 0
    for path, leaf in flat:
        arr = host[off:off + leaf.numel()].reshape(tuple(leaf.shape))
        off += leaf.numel()
        name = site_name(path, cfg)
        rows = ([(name, arr)] if arr.ndim == 1 else
                [(f"{name}[{i}]", row)
                 for i, row in enumerate(arr.reshape(-1, arr.shape[-1]))])
        for key, row in rows:
            if skip_unvisited and row[INITED] < 0.5:
                continue
            out[key] = _row_record(row)
    return out


class JsonlSink:
    """Bounded JSONL writer: one line per step, ring-buffered on disk.

    The file is compacted (rewritten with only the newest ``max_steps``
    lines) whenever it exceeds ``2 * max_steps`` lines."""

    def __init__(self, path: str, max_steps: Optional[int] = 1024):
        self.path = path
        self.max_steps = max_steps
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lines = 0
        if os.path.exists(path):
            with open(path) as f:
                self._lines = sum(1 for _ in f)
        self._f = open(path, "a")

    def write(self, step: int, records: Dict[str, Dict[str, float]],
              events: Optional[List[dict]] = None,
              perf: Optional[dict] = None):
        line: Dict[str, Any] = {"v": SCHEMA_VERSION, "step": int(step),
                                "sites": records}
        if events:
            line["events"] = events
        if perf:
            line["perf"] = perf
        self._f.write(json.dumps(line) + "\n")
        self._f.flush()
        self._lines += 1
        if self.max_steps is not None and self._lines > 2 * self.max_steps:
            self._compact()

    def _compact(self):
        self._f.close()
        with open(self.path) as f:
            tail = f.readlines()[-self.max_steps:]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(tail)
        os.replace(tmp, self.path)
        self._lines = len(tail)
        self._f = open(self.path, "a")

    def close(self):
        self._f.close()


class MemorySink:
    """In-memory per-site aggregator (mean/max over the run)."""

    def __init__(self):
        self.steps = 0
        self.per_site: Dict[str, Dict[str, float]] = {}
        self.last: Dict[str, Dict[str, float]] = {}
        self.events: List[dict] = []
        self.perf: List[dict] = []

    def write(self, step: int, records: Dict[str, Dict[str, float]],
              events: Optional[List[dict]] = None,
              perf: Optional[dict] = None):
        self.steps += 1
        self.last = records
        if events:
            self.events.extend(events)
        if perf:
            self.perf.append({"step": int(step), **perf})
        for name, rec in records.items():
            agg = self.per_site.setdefault(name, {
                "steps": 0, "clip_rate_sum": 0.0, "clip_rate_max": 0.0,
                "sqnr_db_sum": 0.0, "util_sum": 0.0, "drift_max": 0.0,
                "streak_max": 0.0})
            agg["steps"] += 1
            agg["clip_rate_sum"] += rec.get("clip_rate", 0.0)
            agg["clip_rate_max"] = max(agg["clip_rate_max"],
                                       rec.get("clip_rate", 0.0))
            agg["sqnr_db_sum"] += rec.get("sqnr_db", 0.0)
            agg["util_sum"] += rec.get("util", 0.0)
            agg["drift_max"] = max(agg["drift_max"], rec.get("drift", 0.0))
            agg["streak_max"] = max(agg["streak_max"],
                                    rec.get("streak", 0.0))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, a in self.per_site.items():
            n = max(a["steps"], 1)
            out[name] = {
                "steps": a["steps"],
                "clip_rate_mean": a["clip_rate_sum"] / n,
                "clip_rate_max": a["clip_rate_max"],
                "sqnr_db_mean": a["sqnr_db_sum"] / n,
                "util_mean": a["util_sum"] / n,
                "drift_max": a["drift_max"],
                "streak_max": a["streak_max"],
            }
        return out


def read_jsonl(path: str) -> List[Tuple[int, Dict[str, Dict[str, float]]]]:
    """Parse a telemetry JSONL log -> [(step, records)] (bad lines
    skipped)."""
    return [(step, sites) for step, sites, _ in read_jsonl_full(path)]


def read_jsonl_full(
    path: str,
) -> List[Tuple[int, Dict[str, Dict[str, float]], List[dict]]]:
    """Parse a telemetry JSONL log -> [(step, records, events)]."""
    return [(rec["step"], rec["sites"], rec["events"])
            for rec in read_jsonl_records(path)]


def read_jsonl_records(path: str) -> List[Dict[str, Any]]:
    """Parse a telemetry JSONL log into normalized per-line dicts with
    ``v`` (version-less v1 lines normalize to 1), ``step``, ``sites``,
    ``events`` and ``perf`` (``None`` when absent).  Bad lines are
    skipped."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                out.append({
                    "v": int(obj.get("v", 1)),
                    "step": int(obj["step"]),
                    "sites": obj.get("sites", {}) or {},
                    "events": obj.get("events", []) or [],
                    "perf": obj.get("perf"),
                })
            except (ValueError, TypeError, KeyError):
                continue
    return out
