"""The port's step tracer (``repro_torch.telemetry.trace``) against the
cases of ``tests/test_trace.py`` that need no JAX: span nesting and the
Chrome-trace export, the active-tracer helper, ``StepTimer``'s phases and
first-call detection, ``perf_record``; and the ``--trace`` flag of the
port's train and serve drivers on the CPU.  Times are host wall clock,
bounded from below by the sleeps (no device time is claimed)."""
import json
import time

import pytest

from repro_torch.telemetry import trace as trace_mod


def test_span_export_is_valid_chrome_trace(tmp_path):
    tr = trace_mod.Tracer()
    with tr.span("outer", step=3):
        with tr.span("inner"):
            time.sleep(0.002)
    path = tr.export(tmp_path / "trace.json")
    obj = json.load(open(path))
    evs = obj["traceEvents"]
    assert obj["displayTimeUnit"] == "ms"
    assert [e["name"] for e in evs] == ["outer", "inner"]  # sorted by ts
    for e in evs:
        assert e["ph"] == "X"
        for field in ("ts", "dur", "pid", "tid", "name"):
            assert field in e
    outer, inner = evs
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert inner["dur"] >= 2e3  # slept 2ms -> >= 2000us
    assert outer["args"] == {"step": 3}


def test_instant_event_and_non_scalar_args(tmp_path):
    tr = trace_mod.Tracer()
    tr.instant("guard:widen", site="b0/dw/grad", shape=(2, 3))
    path = tr.export(tmp_path / "sub" / "t.json")   # makes the directory
    (ev,) = json.load(open(path))["traceEvents"]
    assert ev["ph"] == "i" and ev["s"] == "t"
    assert ev["args"] == {"site": "b0/dw/grad", "shape": "(2, 3)"}


def test_disabled_tracer_records_nothing():
    tr = trace_mod.Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.instant("y")
    assert tr.events == []


def test_active_tracer_span_helper():
    tr = trace_mod.Tracer()
    prev = trace_mod.set_tracer(tr)
    try:
        assert trace_mod.get_tracer() is tr
        with trace_mod.span("via-active"):
            pass
    finally:
        trace_mod.set_tracer(prev)
    assert [e["name"] for e in tr.events] == ["via-active"]
    with trace_mod.span("dropped"):
        pass
    assert len(tr.events) == 1
    assert not trace_mod.get_tracer().enabled


def test_step_timer_phases_sum_to_total():
    timer = trace_mod.StepTimer()
    with timer.step(0) as st:
        with st.phase("data"):
            time.sleep(0.004)
        with st.execute():
            time.sleep(0.006)
        with st.phase("telemetry"):
            time.sleep(0.002)
        with st.phase("checkpoint"):
            pass
    rec = timer.last
    assert rec["step"] == 0
    assert "compile" in rec["phases"] and "execute" not in rec["phases"]
    assert set(rec["phases"]) == {"data", "compile", "telemetry",
                                  "checkpoint"}
    total = rec["total_ms"]
    s = sum(rec["phases"].values())
    assert s <= total + 1e-6
    assert s >= 0.9 * total

    with timer.step(1) as st:
        with st.execute():
            time.sleep(0.001)
    assert "execute" in timer.last["phases"]
    assert timer.compile_count == 1


def test_step_timer_records_spans_on_its_tracer():
    tr = trace_mod.Tracer()
    timer = trace_mod.StepTimer(tr)
    for s in range(2):
        with timer.step(s) as st:
            with st.phase("data"):
                pass
            with st.execute():
                pass
    assert [e["name"] for e in sorted(tr.events, key=lambda e: e["ts"])] \
        == ["step 0", "data", "compile", "step 1", "data", "execute"]


def test_step_timer_perf_record_throughput():
    timer = trace_mod.StepTimer()
    with pytest.raises(RuntimeError):
        timer.perf_record()
    with timer.step(7) as st:
        with st.execute():
            time.sleep(0.01)
    perf = timer.perf_record(items=256, unit="images")
    assert perf["step_time_ms"] >= 10.0
    assert perf["throughput_unit"] == "images/s"
    assert perf["throughput"] == pytest.approx(
        256 / (perf["step_time_ms"] / 1e3), rel=1e-3)
    assert perf["compile_count"] == 1
    assert "compile" in perf["phases_ms"]
    assert "throughput" not in timer.perf_record()


def test_phase_outside_step_raises():
    timer = trace_mod.StepTimer()
    with pytest.raises(RuntimeError):
        with timer.phase("data"):
            pass


def _names(path):
    return [e["name"] for e in json.load(open(path))["traceEvents"]]


def test_train_driver_trace_flag(tmp_path):
    from repro_torch.launch import train
    path = tmp_path / "train_trace.json"
    run = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "8", "--trace", str(path)])
    names = _names(path)
    assert names.count("data") == 2
    assert names.count("compile") == 1 and names.count("execute") == 1
    assert {"step 0", "step 1"} <= set(names)
    assert len(run.step_ms) == 2 and all(v > 0 for v in run.step_ms)


def test_serve_driver_trace_flag(tmp_path):
    from repro_torch.launch import serve
    path = tmp_path / "serve_trace.json"
    serve.main(["--reduced", "--device", "cpu", "--batch", "1",
                "--prompt-len", "8", "--gen", "3", "--trace", str(path)])
    names = _names(path)
    assert names[0] == "prefill (compile+execute)"
    assert names.count("decode") == 1 and names.count("decode step") == 2
