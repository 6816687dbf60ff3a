"""Port vs reference: the telemetry slice (``repro_torch.telemetry``: the
width-10 site statistics, the overflow guard, the sinks, events and the
report, and the drivers' telemetry flags) against the JAX package on the
CPU.

The first part holds the port to the same oracles as the reference's own
``tests/test_telemetry.py`` (one test here per test there).  The second
part runs the same numpy inputs through both packages; the reference's
small functions are compiled as written (``test_torch_conv.
jit_as_written``: no algebraic simplifier, which would turn ``/ 255`` into
a reciprocal multiply, and no backend optimization, which would contract
the estimators' EMA into an FMA).

Tolerances, stated per test:
  * ``site_stats``, ``update`` with the guard, ``combine_stats`` and the
    probability site's ``_pstats_vector``: every slot bit-equal, except
    ``site_stats``'s err/sig sums (T_ERR, T_SIG): rtol 1e-5, since XLA and
    PyTorch add the squares in another order;
  * a guarded site driven through a distribution shift: ranges, counts,
    utilization, drift and streak bit-equal; err/sig rtol 1e-5;
  * two reduced-starcoder2 train steps (bf16 compute, the guard armed)
    against the JAX simulated backend, compiled as written with XLA's
    bf16 excess precision off (``test_torch_conv.compile_as_written_bf16``:
    every bf16 op rounded, as the port computes; plain ``jax.jit`` keeps
    fused bf16 intermediates such as gelu's in fp32): the ranges as
    ``tests/test_torch_train.py`` holds them (activation 2e-2, gradient
    1e-1 relative); flags, T_N and streaks exact at every site and step;
    after the first step (uninitialized ranges clip nothing) T_CLIP exact
    and the drift zero; the rest within ``TOLS`` (activation / gradient
    sites: err 1.5e-1 / 2.5e-1 and sig 1e-2 / 3e-2 relative, util 2e-2 /
    1e-1 relative, drift 2e-2 / 6e-2 and clip rate 2e-3 absolute).  These
    are not summation-order tolerances: bf16 compute flips single
    quantization levels between XLA and PyTorch (``test_torch_train.py``'s
    docstring), which moves the sampled error sums and the small ranges
    the drift is measured against;
  * one MobileNetV2 block, two SGD-M steps: activation sites' slots
    bit-equal but err/sig (rtol 1e-5); gradient sites within 1e-5 of each
    slot's largest value, as ``tests/test_torch_cnn.py`` holds them;
  * the port's two backends: bit-equal to each other.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import telemetry as jtelemetry
from repro.cnn import layers as jlayers
from repro.core import backend as jbackend
from repro.core import estimators as jestimators
from repro.core import qlinear as jqlinear
from repro.core import quant as jquant
from repro.core.policy import QuantPolicy as JPolicy
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import sgdm as jsgdm
from repro.optim import schedules as jsched
from repro.runtime import steps as jsteps
from repro.telemetry import report as jreport
from repro_torch import configs as tconfigs
from repro_torch import convert, data
from repro_torch import optim as topt
from repro_torch import telemetry
from repro_torch.cnn import layers as tlayers
from repro_torch.core import backend as tbackend
from repro_torch.core import estimators as testimators
from repro_torch.core import qlinear as tqlinear
from repro_torch.core import quant as tquant
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.steps import grads_and_stats, named_params
from repro_torch.telemetry import (T_CLIP, T_DRIFT, T_ERR, T_N, T_SIG,
                                   T_STREAK, T_UTIL, TELEMETRY_WIDTH,
                                   TelemetryConfig)
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import report as treport
from test_torch_cnn import _block_apply, _block_init  # noqa: F401
from test_torch_cnn import ref_rsqrt_as_division  # noqa: F401
from test_torch_conv import compile_as_written_bf16, jit_as_written
from test_torch_train import _jax_noise, _np, _torch_batch

ARCH = "starcoder2-3b"
ACT = tquant.QuantSpec(bits=8, symmetric=False, stochastic=False)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)


def _tele_policy(backend="simulated", **kw):
    return TPolicy.w8a8g8(backend=backend).with_telemetry(**kw)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _base(x: torch.Tensor) -> torch.Tensor:
    mn, mx = tquant.tensor_minmax(x)
    return torch.stack([mn, mx, torch.ones(())])


# ===========================================================================
# The reference's telemetry tests, on the port.
# ===========================================================================
def test_clip_rate_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(64, 32)).astype(np.float32)
    x = _t(xn)
    st = telemetry.site_stats(x, torch.tensor(-1.0), torch.tensor(1.5),
                              ACT, _base(x), sample=0).numpy()
    assert st.shape == (TELEMETRY_WIDTH,)
    assert st[T_CLIP] == np.sum((xn < -1.0) | (xn > 1.5))
    assert st[T_N] == xn.size
    scale = (1.5 - (-1.0)) / 255.0
    zp = np.round(255 * 1.0 / 2.5)
    q = np.clip(np.round(xn / scale + zp), 0, 255)
    deq = (q - zp) * scale
    np.testing.assert_allclose(st[T_ERR], np.sum((xn - deq) ** 2),
                               rtol=1e-4)
    np.testing.assert_allclose(st[T_SIG], np.sum(xn ** 2), rtol=1e-5)
    np.testing.assert_allclose(st[T_UTIL], (xn.max() - xn.min()) / 2.5,
                               rtol=1e-5)


def test_sampled_counters_scale_to_full_size():
    xn = np.random.default_rng(1).normal(size=(4096,)).astype(np.float32)
    x = _t(xn)
    st = telemetry.site_stats(x, torch.tensor(-0.5), torch.tensor(0.5), ACT,
                              _base(x), sample=512).numpy()
    assert st[T_N] == 4096
    assert st[T_CLIP] == np.sum((xn[:512] < -0.5) | (xn[:512] > 0.5)) * 8.0
    exact = np.mean((xn < -0.5) | (xn > 0.5))
    assert abs(st[T_CLIP] / st[T_N] - exact) < 0.05


def test_sqnr_sane_for_8bit():
    x = _t(np.random.default_rng(2).normal(size=(256, 64)))
    mn, mx = tquant.tensor_minmax(x)
    st = telemetry.site_stats(x, mn, mx, ACT, _base(x), sample=0)
    assert 25.0 < float(telemetry.sqnr_db(st)) < 60.0


def test_combine_stats_width10():
    a = np.zeros(10, np.float32)
    b = np.zeros(10, np.float32)
    a[:3] = [-1.0, 2.0, 1.0]
    a[3:] = [5, 100, 0.5, 50.0, 0.8, 0.0, 0.0]
    b[:3] = [-3.0, 1.0, 1.0]
    b[3:] = [7, 100, 0.25, 60.0, 0.9, 0.0, 0.0]
    out = tqlinear.combine_stats(_t(a), _t(b)).numpy()
    assert out[0] == -3.0 and out[1] == 2.0 and out[2] == 1.0
    assert out[T_CLIP] == 12 and out[T_N] == 200
    np.testing.assert_allclose(out[T_ERR], 0.75)
    np.testing.assert_allclose(out[T_SIG], 110.0)
    np.testing.assert_allclose(out[T_UTIL], 0.9)   # max-combined


def test_combine_stats_unvisited_side_does_not_contaminate():
    a = np.zeros(10, np.float32)
    a[:3] = [-1.0, 2.0, 1.0]
    a[3:5] = [5, 100]
    out = tqlinear.combine_stats(_t(a), torch.zeros(10)).numpy()
    assert out[0] == -1.0 and out[1] == 2.0 and out[2] == 1.0
    assert out[T_CLIP] == 5 and out[T_N] == 100


def _run_steps(policy, steps=1, grad_accum=1, batch=8, seed=0):
    cfg = tconfigs.get_reduced(ARCH)
    opt = topt.adamw(weight_decay=0.0)
    state = tsteps.init_train_state(cfg, opt, policy, device="cpu")
    stream = data.for_arch(cfg, seq_len=32, global_batch=batch, seed=seed)
    step = tsteps.make_train_step(cfg, policy, opt, topt.constant(1e-3),
                                  grad_accum=grad_accum)
    losses = []
    for i in range(steps):
        state, met = step(state, stream.batch(i))
        losses.append(float(met["loss"]))
    return state, losses


def test_grad_accum_counts_sum_across_microbatches():
    """grad_accum=2 observes every element once: the per-step element
    counts equal the full batch's, the head's grad site's too (the
    cotangent channel)."""
    q1 = _run_steps(_tele_policy(), grad_accum=1)[0]["quant"]
    q2 = _run_steps(_tele_policy(), grad_accum=2)[0]["quant"]
    for kind in ("act", "grad"):
        n1, n2 = float(q1["head"][kind][T_N]), float(q2["head"][kind][T_N])
        assert n1 > 0 and n1 == n2, (kind, n1, n2)


def test_telemetry_states_are_width10_and_default_width3():
    cfg = tconfigs.get_reduced(ARCH)
    opt = topt.adamw(weight_decay=0.0)
    s_def = tsteps.init_train_state(cfg, opt, device="cpu")
    s_tel = tsteps.init_train_state(cfg, opt, _tele_policy(), device="cpu")
    from repro_torch.core.state import tree_leaves
    assert all(l.shape[-1] == 3 for l in tree_leaves(s_def["quant"]))
    assert all(l.shape[-1] == TELEMETRY_WIDTH
               for l in tree_leaves(s_tel["quant"]))


def _drive_site(tcfg, scales, seed=0, momentum=0.9, kind="hindsight"):
    """One activation site through a scripted scale schedule (the
    reference test's driver, on the port); returns the trajectory."""
    cfg = testimators.EstimatorConfig(kind=kind, momentum=momentum,
                                      fixed_min=-0.1, fixed_max=0.1)
    base_x = np.random.default_rng(seed).normal(size=(2048,)) \
        .astype(np.float32)
    leaf = torch.zeros((tcfg.stat_width,))
    traj = []
    for s in scales:
        x = _t(base_x * s)
        qmin, qmax = testimators.ranges(cfg, leaf, x, ACT, len(traj),
                                        telemetry=tcfg)
        st = testimators.stats(cfg, x, qmin, qmax)
        if tcfg.enabled:
            st = telemetry.site_stats(x, qmin, qmax, ACT, st, sample=0)
        leaf = testimators.update(cfg, leaf, st, telemetry=tcfg)
        clip = float(np.mean((base_x * s < float(qmin))
                             | (base_x * s > float(qmax))))
        traj.append({"leaf": leaf.numpy().copy(), "clip": clip,
                     "qmin": float(qmin), "qmax": float(qmax)})
    return traj


SHIFT = [1.0] * 5 + [8.0] * 10
GUARD = TelemetryConfig(enabled=True, guard=True, clip_threshold=0.01,
                        patience=3)
DYNAMIC = TelemetryConfig(enabled=True, guard=True, clip_threshold=0.01,
                          patience=3, mode="dynamic", recover_margin=0.25)


def test_guard_widens_after_patience_steps():
    guarded = _drive_site(GUARD, SHIFT)
    unguarded = _drive_site(TelemetryConfig(enabled=True, guard=False),
                            SHIFT)
    streaks = [t["leaf"][T_STREAK] for t in guarded]
    assert max(streaks[5:9]) >= 2.0
    assert max(t["clip"] for t in guarded[8:12]) < 0.01
    assert min(t["clip"] for t in unguarded[8:12]) > 0.05
    assert guarded[9]["leaf"][1] > 1.5 * unguarded[9]["leaf"][1]
    assert guarded[-1]["clip"] < 0.01
    assert guarded[5]["leaf"][T_DRIFT] > 1.0


def test_guard_dynamic_mode_falls_back_then_recovers():
    traj = _drive_site(DYNAMIC, [1.0] * 5 + [8.0] * 20)
    assert all(t["clip"] <= 0.01 for t in traj[9:14])
    assert traj[-1]["leaf"][T_STREAK] == 0.0
    assert traj[-1]["clip"] < 0.02


def test_guard_never_widens_fixed_ranges():
    tcfg = TelemetryConfig(enabled=True, guard=True, clip_threshold=0.01,
                           patience=2)
    out = _drive_site(tcfg, [8.0] * 6, kind="fixed")[-1]["leaf"]
    assert out[0] == 0.0 and out[1] == 0.0      # FIXED leaf never adopts
    assert out[T_CLIP] / out[T_N] > 0.5
    assert out[T_STREAK] >= 5.0


def test_no_guard_no_state_mutation_beyond_ema():
    tele = _drive_site(TelemetryConfig(enabled=True, guard=False), [1.0] * 8)
    plain = _drive_site(TelemetryConfig(enabled=False), [1.0] * 8)
    for t, p in zip(tele, plain):
        np.testing.assert_array_equal(t["leaf"][:3], p["leaf"])


def test_train_telemetry_jsonl_and_report(tmp_path, capsys):
    """The driver with ``--telemetry --guard``: one JSONL line per step
    with the reference's site names, rendered by the port's report."""
    run = ttrain.main(["--reduced", "--device", "cpu", "--steps", "3",
                       "--batch", "4", "--seq", "32", "--telemetry",
                       "--guard", "--telemetry-dir", str(tmp_path)])
    log = run.telemetry_path
    lines = [json.loads(ln) for ln in open(log)]
    assert [ln["step"] for ln in lines] == [0, 1, 2]
    assert all(ln["v"] == telemetry.SCHEMA_VERSION and "perf" in ln
               for ln in lines)
    recs = lines[-1]["sites"]
    assert "decoder/blocks/b0/attn/core/p/act[1]" in recs
    r = recs["head/act"]
    for field in ("clip_rate", "sqnr_db", "util", "drift", "streak"):
        assert field in r
    assert 0.0 <= r["clip_rate"] <= 1.0 and r["n"] > 0
    summary = treport.main([log])
    out = capsys.readouterr().out
    assert "head/act" in out and "clip%max" in out
    assert summary["head/act"]["steps"] == 3
    perf = treport.main([log, "--perf"])
    assert perf["steps"] == 3 and "telemetry" in perf["phases"]


def test_jsonl_ring_buffer_bounds_file(tmp_path):
    log = str(tmp_path / "t.jsonl")
    sink = telemetry.JsonlSink(log, max_steps=5)
    for i in range(23):
        sink.write(i, {"s": {"qmin": 0.0, "qmax": 1.0, "inited": 1.0}})
    sink.close()
    lines = [json.loads(ln) for ln in open(log)]
    assert len(lines) <= 10
    assert lines[-1]["step"] == 22


def test_memory_sink_summary():
    sink = telemetry.MemorySink()
    sink.write(0, {"a": {"clip_rate": 0.1, "sqnr_db": 30.0, "util": 0.9,
                         "drift": 0.1, "streak": 0.0}})
    sink.write(1, {"a": {"clip_rate": 0.3, "sqnr_db": 20.0, "util": 0.8,
                         "drift": 0.5, "streak": 2.0}})
    s = sink.summary()["a"]
    np.testing.assert_allclose(s["clip_rate_mean"], 0.2)
    np.testing.assert_allclose(s["clip_rate_max"], 0.3)
    np.testing.assert_allclose(s["drift_max"], 0.5)
    assert s["streak_max"] == 2.0


def test_default_path_unchanged_bitwise():
    """Telemetry off: losses and quant states bit-identical run to run, and
    the ranges equal the telemetry run's base slots (the counters never
    feed back without the guard)."""
    s1, l1 = _run_steps(TPolicy.w8a8g8(), steps=2, batch=4)
    s2, l2 = _run_steps(TPolicy.w8a8g8(), steps=2, batch=4)
    s3, l3 = _run_steps(_tele_policy(), steps=2, batch=4)
    assert l1 == l2 == l3
    from repro_torch.core.state import tree_leaves
    for a, b, c in zip(*(tree_leaves(s["quant"]) for s in (s1, s2, s3))):
        assert torch.equal(a, b) and torch.equal(a, c[:3])


def test_serve_prefill_stats(tmp_path):
    """``launch.serve --telemetry PATH``: per-site prefill records, the
    probability sites' exact counters among them."""
    path = tmp_path / "serve.jsonl"
    run = tserve.main(["--reduced", "--batch", "2", "--prompt-len", "16",
                       "--gen", "2", "--device", "cpu", "--telemetry",
                       str(path)])
    ((step, recs),) = telemetry.read_jsonl(str(path))
    assert step == 0 and recs
    assert all(0.0 <= r["clip_rate"] <= 1.0 for r in recs.values())
    p = recs["decoder/blocks/b0/attn/core/p/act[0]"]
    # The p-site sees every probability: B x heads x S x S elements.
    assert p["n"] == 2 * 4 * 16 * 16
    assert run.prefill_stats["decoder"]["layers"][0]["attn"]["core"]["p"][
        "act"].shape == (TELEMETRY_WIDTH,)


def _events_from_traj(tcfg, traj, family="act"):
    det = telemetry.GuardEventDetector(tcfg)
    events = []
    for step, t in enumerate(traj):
        events += det.update(step, telemetry.collect({family: _t(t["leaf"])}))
    return events


def test_widen_event_emitted_exactly_at_trigger():
    events = _events_from_traj(GUARD, _drive_site(GUARD, SHIFT))
    widens = [e for e in events if e["action"] == "widen"]
    assert len(widens) == 1, events
    ev = widens[0]
    assert ev["step"] == 7 and ev["site"] == "act"
    assert ev["new"][1] > ev["old"][1]
    assert ev["clip_rate"] > GUARD.clip_threshold and ev["streak"] == 0.0


def test_no_events_without_guard_or_when_healthy():
    assert _events_from_traj(GUARD, _drive_site(GUARD, [1.0] * 8)) == []
    off = TelemetryConfig(enabled=True, guard=False)
    assert _events_from_traj(off, _drive_site(off, [1.0] * 5 + [8.0] * 5)) \
        == []


def test_dynamic_mode_enter_exit_events():
    events = _events_from_traj(DYNAMIC,
                               _drive_site(DYNAMIC, [1.0] * 5 + [8.0] * 20))
    actions = [e["action"] for e in events]
    assert "fallback_enter" in actions and "fallback_exit" in actions
    assert actions.index("fallback_enter") < actions.index("fallback_exit")


def test_jsonl_events_roundtrip_and_report(tmp_path, capsys):
    det = telemetry.GuardEventDetector(GUARD)
    path = str(tmp_path / "t.jsonl")
    sink = telemetry.JsonlSink(path, max_steps=64)
    for step, t in enumerate(_drive_site(GUARD, SHIFT)):
        records = telemetry.collect({"act": _t(t["leaf"])})
        sink.write(step, records, det.update(step, records))
    sink.close()
    evs = [e for _, _, events in telemetry.read_jsonl_full(path)
           for e in events]
    assert len(evs) == 1 and evs[0]["action"] == "widen"
    treport.main([path])
    out = capsys.readouterr().out
    assert "guard events" in out and "widen" in out


# ===========================================================================
# Parity with the reference on the same inputs.
# ===========================================================================
SPECS = {"act": (ACT, jquant.QuantSpec(bits=8)),
         "kv": (tquant.QuantSpec(bits=8, symmetric=True),
                jquant.QuantSpec(bits=8, symmetric=True)),
         "grad": (tquant.QuantSpec(bits=8, stochastic=True),
                  jquant.QuantSpec(bits=8, stochastic=True))}


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("sample", [0, 512, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_site_stats_matches_reference(spec, sample, dtype):
    """The port samples a permuted view (head-major, as the attention
    sites hold q) in its logical order, as the reference samples its
    ravel."""
    rng = np.random.default_rng(sample + len(spec))
    x = (rng.standard_normal((3, 37, 2, 29)) * 1.7).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xn = np.asarray(xj.astype(jnp.float32))
    lo, hi = np.float32(-2.1), np.float32(2.9)          # clips both tails
    ts, js = SPECS[spec]
    base = np.array([xn.min(), xn.max(), 1.0], np.float32)
    ref = np.asarray(jit_as_written(
        lambda a, l, h, b: jtelemetry.site_stats(a, l, h, js, b, sample),
        xj, lo, hi, jnp.asarray(base)))
    xt = torch.from_numpy(np.ascontiguousarray(xn.transpose(0, 2, 1, 3)))
    xt = xt.to(getattr(torch, dtype)).permute(0, 2, 1, 3)
    assert not xt.is_contiguous()
    got = telemetry.site_stats(xt, torch.tensor(lo), torch.tensor(hi), ts,
                               _t(base), sample).numpy()
    exact = [i for i in range(10) if i not in (T_ERR, T_SIG)]
    np.testing.assert_array_equal(got[exact], ref[exact])
    np.testing.assert_allclose(got[[T_ERR, T_SIG]], ref[[T_ERR, T_SIG]],
                               rtol=1e-5)


def _random_states(rng, n=64):
    """``n`` width-10 (leaf, stat) rows covering visited/unvisited,
    inited/uninited, clipping and healthy sites, streaks below, at and
    above patience."""
    leaf = np.zeros((n, 10), np.float32)
    stat = np.zeros((n, 10), np.float32)
    lo = -rng.random(n).astype(np.float32) * 3
    leaf[:, 0], leaf[:, 1] = lo, lo + rng.random(n).astype(np.float32) * 5
    leaf[:, 2] = rng.random(n) < 0.8
    leaf[:, 3:7] = rng.random((n, 4)) * 100
    leaf[:, 7:9] = rng.random((n, 2))
    leaf[:, 9] = rng.integers(0, 5, n)
    stat[:, 0] = leaf[:, 0] * rng.uniform(0.5, 3.0, n)
    stat[:, 1] = leaf[:, 1] * rng.uniform(0.5, 3.0, n)
    stat[:, 2] = rng.random(n) < 0.85
    stat[:, 4] = rng.integers(100, 5000, n)
    stat[:, 3] = stat[:, 4] * rng.choice([0.0, 0.001, 0.02, 0.3], n)
    stat[:, 5:7] = rng.random((n, 2)) * 50
    stat[:, 7] = rng.random(n) * 2
    return leaf, stat


@pytest.mark.parametrize("kind", ["hindsight", "running", "current", "dsgc",
                                  "fixed"])
@pytest.mark.parametrize("tcfg", [
    dict(enabled=True), dict(enabled=True, guard=True, patience=2),
    dict(enabled=True, guard=True, patience=3, mode="dynamic",
         recover_margin=0.1)], ids=["metrics", "widen", "dynamic"])
def test_update_with_guard_matches_reference(kind, tcfg):
    """The width-10 estimator update (drift, streak, widen) on [64, 10]
    rows: bit-equal."""
    leaf, stat = _random_states(np.random.default_rng(len(kind)))
    tj = jtelemetry.TelemetryConfig(**tcfg)
    tt = TelemetryConfig(**tcfg)
    cj = jestimators.EstimatorConfig(kind=kind, momentum=0.9)
    ct = testimators.EstimatorConfig(kind=kind, momentum=0.9)
    ref = np.asarray(jit_as_written(
        lambda a, b: jestimators.update(cj, a, b, telemetry=tj),
        jnp.asarray(leaf), jnp.asarray(stat)))
    got = testimators.update(ct, _t(leaf), _t(stat), telemetry=tt).numpy()
    np.testing.assert_array_equal(got, ref)


def test_combine_stats_and_pstats_vector_match_reference():
    rng = np.random.default_rng(5)
    a, b = _random_states(rng)
    ref = np.asarray(jit_as_written(jqlinear.combine_stats, jnp.asarray(a),
                                    jnp.asarray(b)))
    np.testing.assert_array_equal(tqlinear.combine_stats(_t(a), _t(b))
                                  .numpy(), ref)
    stats6 = np.array([0.0, 0.93, 17.0, 8192.0, 0.0123, 41.5], np.float32)
    for tele in (False, True):
        pj = JPolicy.w8a8g8()
        pt = TPolicy.w8a8g8()
        if tele:
            pj, pt = pj.with_telemetry(), pt.with_telemetry()
        ref = np.asarray(jit_as_written(
            lambda s, lo, hi: jbackend._pstats_vector(pj, s, lo, hi),
            jnp.asarray(stats6), np.float32(0.0), np.float32(0.8)))
        got = tbackend._pstats_vector(pt, _t(stats6), torch.tensor(0.0),
                                      torch.tensor(0.8)).numpy()
        np.testing.assert_array_equal(got, ref)


def _jax_drive(tcfg, scales, seed=0):
    """The reference's own ``_drive_site`` (tests/test_telemetry.py) with
    each step's three functions compiled as written."""
    cfg = jestimators.EstimatorConfig(kind="hindsight", momentum=0.9)
    spec = jquant.QuantSpec(bits=8)
    base_x = np.random.default_rng(seed).normal(size=(2048,)) \
        .astype(np.float32)

    def step(leaf, x, i):
        qmin, qmax = jestimators.ranges(cfg, leaf, x, spec, i, telemetry=tcfg)
        st = jestimators.stats(cfg, x, qmin, qmax)
        st = jtelemetry.site_stats(x, qmin, qmax, spec, st, sample=0)
        return jestimators.update(cfg, leaf, st, telemetry=tcfg)

    leaf = jnp.zeros((tcfg.stat_width,), jnp.float32)
    out = []
    for i, s in enumerate(scales):
        leaf = jit_as_written(step, leaf, jnp.asarray(base_x * s),
                              jnp.int32(i))
        out.append(np.asarray(leaf))
    return out


@pytest.mark.parametrize("mode", ["widen", "dynamic"])
def test_guarded_site_trajectory_matches_reference(mode):
    tt = GUARD if mode == "widen" else DYNAMIC
    tj = jtelemetry.TelemetryConfig(**dataclasses.asdict(tt))
    scales = [1.0] * 5 + [8.0] * 12
    ref = _jax_drive(tj, scales)
    got = [t["leaf"] for t in _drive_site(tt, scales)]
    exact = [i for i in range(10) if i not in (T_ERR, T_SIG)]
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(b[exact], a[exact], err_msg=str(i))
        np.testing.assert_allclose(b[[T_ERR, T_SIG]], a[[T_ERR, T_SIG]],
                                   rtol=1e-5, err_msg=str(i))


# ---------------------------------------------------------------------------
# Two telemetry-on train steps against the JAX simulated backend.
# ---------------------------------------------------------------------------
LR, SEQ, BATCH = 3e-3, 32, 4


@pytest.fixture(scope="module")
def tele_steps():
    """The reference's init, two steps of its simulated backend with
    telemetry and the guard on, and the port's two backends from the same
    init, batches and noise (bf16 compute)."""
    cfg_j = jconfigs.get_reduced(ARCH)
    cfg_t = tconfigs.get_reduced(ARCH)
    pj = JPolicy.w8a8g8(backend="simulated").with_telemetry(guard=True)
    opt = jadamw(weight_decay=0.0)
    init = _np(jax.jit(lambda k: jsteps.init_train_state(k, cfg_j, opt, pj))(
        jax.random.PRNGKey(0)))
    stream = jdata.for_arch(cfg_j, seq_len=SEQ, global_batch=BATCH, seed=0)
    batches = [_np(stream.batch(i)) for i in range(2)]
    state = jax.tree_util.tree_map(jnp.asarray, init)
    ts = compile_as_written_bf16(
        jsteps.make_train_step(cfg_j, pj, opt, jsched.constant(LR)), state,
        batches[0])
    ref = []
    for b in batches:
        state, met = ts(state, b)
        ref.append((float(met["loss"]), _np(state["quant"])))
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbackend, "site_noise", _jax_noise)
        for bk in ("simulated", "fused"):
            o = topt.adamw(weight_decay=0.0)
            st = convert.train_state_from_jax(init, cfg_t, o, "cpu")
            step = tsteps.make_train_step(
                cfg_t, TPolicy.w8a8g8(backend=bk).with_telemetry(guard=True),
                o, topt.constant(LR))
            port[bk] = []
            for b in batches:
                st, met = step(st, _torch_batch(b))
                port[bk].append((float(met["loss"]),
                                 convert.to_jax_layout(st["quant"], cfg_t)))
    return ref, port


def _quant_rows(tree):
    return {jax.tree_util.keystr(p): np.asarray(v).reshape(-1, 10)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# Measured worst deviations (act / grad sites) after step 0 and step 1:
# err 2.5e-2 / 4.3e-2 and 9.6e-2 / 1.3e-1 relative, sig 1.0e-3 / 4.2e-3
# and 4.0e-3 / 1.3e-2, util 0 and 8.2e-3 / 6.0e-2, drift 0 and 7.6e-3 /
# 2.7e-2 absolute, clip rate 0 and 2.4e-4 / 4.9e-4 absolute.
TOLS = {"act": dict(rng=2e-2, err=1.5e-1, sig=1e-2, util=2e-2, drift=2e-2,
                    rate=2e-3),
        "grad": dict(rng=1e-1, err=2.5e-1, sig=3e-2, util=1e-1, drift=6e-2,
                     rate=2e-3)}


def test_two_telemetry_steps_match_jax_simulated(tele_steps):
    """Every slot of every site after each step (tolerances in ``TOLS``,
    see the module docstring): T_N and the flags exact; after the first
    step the clip counts exact and the drift zero on both sides."""
    ref, port = tele_steps
    for bk, got in port.items():
        for i, ((lr, qr), (lt, qt)) in enumerate(zip(ref, got)):
            assert abs(lt - lr) <= 3e-3 * abs(lr), (bk, i, lt, lr)
            rows_r, rows_t = _quant_rows(qr), _quant_rows(qt)
            assert sorted(rows_r) == sorted(rows_t)
            for name, a in rows_r.items():
                b = rows_t[name]
                what = f"{bk} step {i} {name}"
                tol = TOLS["grad" if "'grad'" in name else "act"]
                for slot in (2, T_N, T_STREAK):
                    np.testing.assert_array_equal(b[:, slot], a[:, slot],
                                                  what)
                for slot, key in ((0, "rng"), (1, "rng"), (T_ERR, "err"),
                                  (T_SIG, "sig"), (T_UTIL, "util")):
                    np.testing.assert_allclose(
                        b[:, slot], a[:, slot], rtol=tol[key], atol=1e-12,
                        err_msg=f"{what} slot {slot}")
                np.testing.assert_allclose(b[:, T_DRIFT], a[:, T_DRIFT],
                                           rtol=0, atol=tol["drift"],
                                           err_msg=what)
                rate_b = b[:, T_CLIP] / np.maximum(b[:, T_N], 1)
                rate_a = a[:, T_CLIP] / np.maximum(a[:, T_N], 1)
                np.testing.assert_allclose(rate_b, rate_a, rtol=0,
                                           atol=tol["rate"], err_msg=what)
                if i == 0:
                    np.testing.assert_array_equal(b[:, T_CLIP], a[:, T_CLIP],
                                                  what)
                    np.testing.assert_array_equal(b[:, T_DRIFT], 0.0, what)


def test_port_backends_agree_bitwise_with_telemetry(tele_steps):
    _, port = tele_steps
    for (ls, qs), (lf, qf) in zip(port["simulated"], port["fused"]):
        assert ls == lf
        rs, rf = _quant_rows(qs), _quant_rows(qf)
        for name in rs:
            np.testing.assert_array_equal(rs[name], rf[name], name)


# ---------------------------------------------------------------------------
# One MobileNetV2 block with telemetry on.
# ---------------------------------------------------------------------------
def _widen_np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 7)]), tree)


def _block_jax_tele(params, bn, sites, x, labels, steps=2):
    policy = JPolicy.w8a8g8(backend="simulated").with_telemetry(guard=True)
    opt = jsgdm(momentum=0.9)

    def step_fn(state, step):
        def lf(p, q):
            logits, new_bn, st = _block_apply(
                jlayers, jqlinear, jax.nn.relu6, p, state["bn"], q,
                jnp.asarray(x), policy, jnp.int32(7), step)
            logz = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                                       1)[:, 0]
            return jnp.mean(logz - gold), (new_bn, st)
        (loss, (new_bn, st)), (pg, qg) = jax.value_and_grad(
            lf, argnums=(0, 1), has_aux=True)(state["params"],
                                              state["quant"])
        updates, new_opt = opt.update(pg, state["opt"], state["params"], 0.05)
        return {"params": japply(state["params"], updates),
                "bn": new_bn, "opt": new_opt,
                "quant": jqlinear.update_quant_state(
                    policy, state["quant"], jqlinear.merge_stats(st, qg))}, \
            loss

    state = {"params": params, "bn": bn, "opt": opt.init(params),
             "quant": sites}
    out = []
    for s in range(steps):
        state, loss = jit_as_written(step_fn, state, jnp.int32(s))
        out.append((float(loss), _np(state["quant"])))
    return out


def _block_port_tele(backend, params, bn, sites, x, labels, steps=2):
    policy = TPolicy.w8a8g8(backend=backend).with_telemetry(guard=True)
    p, b, q = convert.cnn_state_from_jax(params, bn, sites, device="cpu")
    for t in p.parameters():
        t.requires_grad_(True)
    opt = topt.sgdm(momentum=0.9)
    ost = opt.init(named_params(p))
    xt, lt = torch.from_numpy(x.copy()), torch.from_numpy(labels)
    out = []
    for s in range(steps):
        def loss_of_quant(qi):
            logits, new_bn, st = _block_apply(
                tlayers, tqlinear, torch.nn.functional.relu6, p, b, qi, xt,
                policy, 7, s)
            loss = torch.mean(torch.logsumexp(logits, -1)
                              - logits.gather(1, lt[:, None])[:, 0])
            return loss, st, new_bn
        loss, pg, stats, b = grads_and_stats(loss_of_quant, p, q)
        ost = opt.update(pg, ost, named_params(p), 0.05)
        with torch.no_grad():
            q = tqlinear.update_quant_state(policy, q, stats)
        out.append((float(loss), {k: {kk: vv.numpy().copy()
                                      for kk, vv in v.items()}
                                  for k, v in q.items()}))
    return out


def test_mbv2_block_with_telemetry_matches_reference(jax_noise,
                                                     ref_rsqrt_as_division):
    params, bn, sites, x, labels = _block_init()
    sites = _widen_np(sites)
    ref = _block_jax_tele(params, bn, sites, x, labels)
    port = {bk: _block_port_tele(bk, params, bn, sites, x, labels)
            for bk in ("simulated", "fused")}
    exact = [i for i in range(10) if i not in (T_ERR, T_SIG)]
    for (ls, qs), (lf, qf) in zip(port["simulated"], port["fused"]):
        assert ls == lf
        for k in qs:
            for kind in qs[k]:
                np.testing.assert_array_equal(qs[k][kind], qf[k][kind])
    for s, ((lj, qj), (lt, qt)) in enumerate(zip(ref, port["simulated"])):
        assert lt == lj, f"step {s} loss"
        for site in qj:
            a, b = qj[site]["act"], qt[site]["act"]
            what = f"step {s} {site}/act"
            np.testing.assert_array_equal(b[exact], a[exact], what)
            np.testing.assert_allclose(b[[T_ERR, T_SIG]], a[[T_ERR, T_SIG]],
                                       rtol=1e-5, err_msg=what)
            a, b = qj[site]["grad"], qt[site]["grad"]
            assert b[2] == a[2] == 1.0 and b[T_N] == a[T_N]
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-5 * np.abs(a).max(),
                                       err_msg=f"step {s} {site}/grad")


# ---------------------------------------------------------------------------
# Cross-package logs, the CNN driver, and the cost rules.
# ---------------------------------------------------------------------------
def test_jsonl_renders_across_packages(tmp_path):
    """A port JSONL renders with the reference's ``report.summarize`` and
    a reference JSONL with the port's, site names and numbers equal."""
    traj = _drive_site(GUARD, SHIFT)
    ref_log, port_log = str(tmp_path / "ref.jsonl"), str(tmp_path / "p.jsonl")
    js = jtelemetry.JsonlSink(ref_log)
    ts = telemetry.JsonlSink(port_log)
    jdet, tdet = jtelemetry.GuardEventDetector(jtelemetry.TelemetryConfig(
        **dataclasses.asdict(GUARD))), telemetry.GuardEventDetector(GUARD)
    for step, t in enumerate(traj):
        rj = jtelemetry.collect({"blocks": {"act": jnp.asarray(
            np.stack([t["leaf"], t["leaf"]]))}})
        rt = telemetry.collect({"blocks": {"act": _t(
            np.stack([t["leaf"], t["leaf"]]))}})
        assert rj == rt
        js.write(step, rj, jdet.update(step, rj))
        ts.write(step, rt, tdet.update(step, rt))
    js.close()
    ts.close()
    assert jreport.summarize(port_log, with_events=True) == \
        treport.summarize(ref_log, with_events=True)
    summary, events = treport.summarize(port_log, with_events=True)
    assert set(summary) == {"blocks/act[0]", "blocks/act[1]"}
    assert len(events) == 2


def test_cnn_driver_telemetry(tmp_path):
    """``cnn.train --guard``: width-10 quant leaves, one JSONL line per
    step with its perf record, every site's counters finite."""
    from repro_torch.cnn import train as cnn_train
    out = tmp_path / "cnn.jsonl"
    run = cnn_train.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                          "--image-size", "16", "--num-classes", "4",
                          "--arch", "mobilenetv2", "--guard",
                          "--telemetry-out", str(out)])
    assert run.policy.backend == "fused" and run.policy.telemetry.guard
    recs = telemetry.read_jsonl_records(str(out))
    assert [r["step"] for r in recs] == [0, 1]
    assert all(r["perf"]["throughput_unit"] == "images/s" for r in recs)
    sites = recs[-1]["sites"]
    assert len(sites) == 106
    assert all(math.isfinite(v) for r in sites.values() for v in r.values())


def test_fused_rejects_the_dynamic_guard():
    """The fused backend cannot honour the dynamic fallback (a dynamic
    range): a ``ValueError``, as in the reference, from the policy and the
    driver alike; widen mode is legal."""
    with pytest.raises(ValueError, match="dynamic"):
        TPolicy.w8a8g8(backend="fused").with_telemetry(guard=True,
                                                       mode="dynamic")
    with pytest.raises(ValueError, match="dynamic"):
        ttrain.main(["--reduced", "--device", "cpu", "--steps", "1",
                     "--guard", "--guard-mode", "dynamic"])
    TPolicy.w8a8g8(backend="fused").with_telemetry(guard=True)


def test_head_grad_leaf_folds_its_own_tail():
    """The head's grad slot of the forward stats tree carries the head's
    grad leaf itself (as in the reference), so at width 10 the merge also
    adds that leaf's counters: the head grad site's T_N grows by one
    step's count per step, where every other grad site holds one step's."""
    cfg = tconfigs.get_reduced(ARCH)
    n = 4 * 32 * cfg.d_model
    policy = _tele_policy()
    opt = topt.adamw(weight_decay=0.0)
    state = tsteps.init_train_state(cfg, opt, policy, device="cpu")
    stream = data.for_arch(cfg, seq_len=32, global_batch=4, seed=0)
    step = tsteps.make_train_step(cfg, policy, opt, topt.constant(1e-3))
    for i in range(3):
        state, _ = step(state, stream.batch(i))
        assert float(state["quant"]["head"]["grad"][T_N]) == (i + 1) * n
        assert float(state["quant"]["head"]["act"][T_N]) == n
        up = state["quant"]["decoder"]["layers"][0]["mlp"]["up"]["grad"]
        assert float(up[T_N]) == 4 * 32 * cfg.d_ff


def test_site_stats_prefix_copies_no_full_tensor(monkeypatch):
    """On a permuted view, ``site_stats`` casts only the sampled prefix:
    no fp32 copy of the whole tensor is made."""
    x = torch.randn(64, 3, 40, 40).to(torch.bfloat16).permute(0, 2, 3, 1)
    seen = []
    real = torch.Tensor.to

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        if out.dtype == torch.float32 and self.dtype == torch.bfloat16:
            seen.append(self.numel())
        return out
    monkeypatch.setattr(torch.Tensor, "to", spy)
    st = tmetrics.site_stats(x, torch.tensor(-1.0), torch.tensor(1.0), ACT,
                             torch.tensor([-3.0, 3.0, 1.0]), 4096)
    assert seen == [4096] and float(st[T_N]) == x.numel()
    flat = x.reshape(-1)[:4096].float()
    assert float(st[T_CLIP]) == float(((flat < -1) | (flat > 1)).sum()) * \
        x.numel() / 4096
