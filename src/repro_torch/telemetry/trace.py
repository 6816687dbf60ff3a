"""Host-side performance tracing: spans, step-phase timing, Chrome trace
(port of ``repro/telemetry/trace.py``; stdlib only, copied).

The paper's claim is a *performance* claim — in-hindsight ranges make the
quantization hot path static and single-pass — so the repo needs to
observe where time goes, not only quantization quality.  This module is
the host half of that observability stack:

  * :class:`Tracer` — a lightweight span recorder.  ``tracer.span(name)``
    is a context manager; every span becomes one Chrome-trace *complete*
    event (``"ph": "X"``), and :meth:`Tracer.export` writes the standard
    ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
    (https://ui.perfetto.dev) load directly.  Disabled tracers are
    no-ops (a handful of ``perf_counter`` calls per step — the tracing
    flag never changes the computation, so traced and untraced runs are
    bit-identical).
  * :class:`StepTimer` — splits each training step into the canonical
    phases ``data`` (host batch assembly), ``compile`` (the first device
    phase of a run: in the port it carries the kernels' first-use build
    and load and every quant site's first-batch double pass, as the
    reference's carries ``jax.jit``'s compilation), ``execute`` (device
    step, fenced by the caller inside the phase with a host read or
    ``torch.cuda.synchronize()``, where the reference waits with
    ``block_until_ready``), ``telemetry`` (host collection/flush) and
    ``checkpoint``.  Each step yields a record with per-phase
    milliseconds; :meth:`StepTimer.perf_record` converts the last step
    into the ``"perf"`` payload of the reference's JSONL telemetry lines.

A module-level *active* tracer (:func:`set_tracer` / :func:`span`) lets
library code emit spans without threading a tracer through every call;
the default active tracer is disabled.

Timebase: ``time.perf_counter()`` throughout — monotonic, unaffected by
wall-clock adjustments (``time.time()`` is not).
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

PHASES = ("data", "compile", "execute", "telemetry", "checkpoint")


class Tracer:
    """Span recorder exporting Chrome-trace-event JSON.

    Spans nest naturally: Perfetto reconstructs the stack from the
    (ts, dur) intervals of same-thread events.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: List[Dict[str, Any]] = []
        self.t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    @contextmanager
    def span(self, name: str, **args):
        """Record ``name`` as a complete ("X") event around the block."""
        if not self.enabled:
            yield
            return
        ts = self._now_us()
        try:
            yield
        finally:
            ev: Dict[str, Any] = {
                "name": str(name), "ph": "X", "cat": "host",
                "ts": ts, "dur": self._now_us() - ts,
                "pid": os.getpid(), "tid": threading.get_ident(),
            }
            if args:
                ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                                  else str(v)) for k, v in args.items()}
            self.events.append(ev)

    def instant(self, name: str, **args):
        """Record a zero-duration instant event (e.g. a guard trigger)."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": str(name), "ph": "i", "s": "t", "cat": "host",
            "ts": self._now_us(),
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else str(v)) for k, v in args.items()}
        self.events.append(ev)

    def export(self, path) -> str:
        """Write the Chrome trace JSON (Perfetto/chrome://tracing format)."""
        path = str(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Active-tracer plumbing: library code calls ``trace.span(...)`` without
# knowing whether the driver armed tracing.
# ---------------------------------------------------------------------------
_NULL_TRACER = Tracer(enabled=False)
_ACTIVE: Tracer = _NULL_TRACER


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the module-level active tracer.

    Returns the previous active tracer so callers can restore it.
    ``None`` resets to the disabled null tracer.
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else _NULL_TRACER
    return prev


def get_tracer() -> Tracer:
    return _ACTIVE


@contextmanager
def span(name: str, **args):
    """``with trace.span("phase"):`` on whatever tracer is active."""
    with _ACTIVE.span(name, **args):
        yield


class StepTimer:
    """Per-step phase breakdown on top of a :class:`Tracer`.

    Usage::

        timer = StepTimer(tracer)
        for step in range(n):
            with timer.step(step) as st:
                with st.phase("data"):
                    batch = stream.batch(step)
                with st.execute():          # "compile" on the first call
                    state, met = train_step(state, batch)
                    torch.cuda.synchronize()
                with st.phase("telemetry"):
                    ...
            sink.write(step, records, events,
                       perf=timer.perf_record(items=tokens, unit="tokens"))

    ``timer.last`` holds the most recent step record:
    ``{"step", "total_ms", "phases": {name: ms}}``.  Phase times are
    wall-clock (``perf_counter``) milliseconds and sum to ~``total_ms``
    (minus the few microseconds between phases).
    """

    def __init__(self, tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else _NULL_TRACER
        self.compile_count = 0
        self.last: Optional[Dict[str, Any]] = None
        self._cur: Optional[Dict[str, Any]] = None

    @contextmanager
    def step(self, step: int):
        rec: Dict[str, Any] = {"step": int(step), "phases": {},
                               "total_ms": 0.0}
        prev, self._cur = self._cur, rec
        t0 = time.perf_counter()
        try:
            with self.tracer.span(f"step {int(step)}", step=int(step)):
                yield self
        finally:
            rec["total_ms"] = (time.perf_counter() - t0) * 1e3
            self.last = rec
            self._cur = prev

    @contextmanager
    def phase(self, name: str):
        if self._cur is None:
            raise RuntimeError("StepTimer.phase used outside StepTimer.step")
        t0 = time.perf_counter()
        try:
            with self.tracer.span(str(name)):
                yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            ph = self._cur["phases"]
            ph[name] = ph.get(name, 0.0) + dt

    @contextmanager
    def execute(self):
        """Device phase with first-call detection.

        The first device phase of a run builds and loads the kernels and
        runs every quant site's first-batch double pass: it is recorded
        as the ``compile`` phase (the reference's name, where ``jax.jit``
        compiles on the first call) and counted in ``compile_count``;
        every later call records ``execute``.  The caller must fence
        inside the block (a host read of a result, or
        ``torch.cuda.synchronize()``) so the phase covers actual device
        time.
        """
        first = self.compile_count == 0
        if first:
            self.compile_count += 1
        with self.phase("compile" if first else "execute"):
            yield

    def perf_record(self, items: Optional[float] = None,
                    unit: str = "items") -> Dict[str, Any]:
        """The ``"perf"`` JSONL payload for the most recent step.

        ``items`` (tokens, images, ...) divided by the step time gives
        the throughput field; ``unit`` names it (``"tokens"`` ->
        ``"tokens/s"``).
        """
        if self.last is None:
            raise RuntimeError("perf_record before any timed step")
        rec: Dict[str, Any] = {
            "step_time_ms": round(self.last["total_ms"], 4),
            "phases_ms": {k: round(v, 4)
                          for k, v in self.last["phases"].items()},
            "compile_count": self.compile_count,
        }
        if items is not None and self.last["total_ms"] > 0:
            rec["throughput"] = round(
                float(items) / (self.last["total_ms"] / 1e3), 3)
            rec["throughput_unit"] = f"{unit}/s"
        return rec
