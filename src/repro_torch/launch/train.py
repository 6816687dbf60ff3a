"""Training entry point (port of ``repro/launch/train.py``).

Runs ``runtime.steps.make_train_step`` for ``--steps`` AdamW (or SGD-M)
steps on the synthetic LM stream, with in-hindsight W8A8G8 quantization.
``--backend fused`` (the default) runs every quantizer and contraction of
the forward and backward pass on the hand-written CUDA kernels;
``--backend simulated`` runs the plain PyTorch fake-quant path.  Runs on
the CUDA card unless ``--device cpu`` is given.  A straggler watchdog
flags steps far above the trailing median; SIGTERM/SIGINT end the run
cleanly after the current step.

Example (H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --batch 4 --seq 1024 --steps 3
CPU, reduced:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 2

``--trace PATH`` exports a Chrome-trace JSON of each step's phases (data,
compile on the first step, execute, telemetry, checkpoint) to PATH.

Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` steps and at the end,
the last ``--keep-last`` kept) hold the whole train state, quant ranges
included; ``--resume`` continues from the newest one bit for bit, and
migrates a width-3 quant state into a telemetry run.  ``--telemetry``
widens every quant site to the width-10 health counters and writes one
JSONL line per step (``--telemetry-dir``/telemetry.jsonl, with the step's
phase breakdown under ``"perf"``; render it with ``python -m
repro_torch.telemetry.report``); ``--guard`` arms the overflow guard,
whose events are printed, logged and marked on the trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
from typing import Optional

import torch

from repro_torch import checkpoint, configs, data, telemetry
from repro_torch.core.estimators import ALL_ESTIMATORS
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import inited_count
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim import adamw, sgdm
from repro_torch.optim.schedules import cosine
from repro_torch.runtime import steps as steps_mod
from repro_torch.telemetry import trace


def build_policy(kind: str, backend: str, args=None) -> QuantPolicy:
    """The ``--policy`` on ``backend``, with the telemetry and guard flags
    of ``args`` when given.  Raises for illegal combinations (a dynamic
    estimator, or the guard's dynamic mode, on 'fused')."""
    if kind == "fp32":
        policy = QuantPolicy.disabled()
    elif kind not in ALL_ESTIMATORS:
        raise ValueError(f"unknown policy {kind!r}")
    else:
        policy = QuantPolicy.w8a8g8(act_kind=kind, grad_kind=kind)
    if args is not None and args.telemetry:
        policy = policy.with_telemetry(
            guard=args.guard, clip_threshold=args.guard_threshold,
            patience=args.guard_patience, widen_factor=args.guard_widen,
            mode=args.guard_mode)
    return policy.with_backend(backend)


class Watchdog:
    """Step-latency heartbeat: flags stragglers for the cluster scheduler."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.durations: list = []
        self.factor = factor
        self.window = window
        self.flagged = 0

    def step(self, dt: float, step: int):
        hist = self.durations[-self.window:]
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dt > self.factor * med:
                self.flagged += 1
                print(f"[watchdog] step {step}: {dt*1e3:.0f}ms "
                      f"(median {med*1e3:.0f}ms) — straggler suspected; "
                      f"a production deployment would alert the scheduler")
        self.durations.append(dt)


@dataclasses.dataclass
class TrainRun:
    """What one training run produced (returned by :func:`main`)."""

    cfg: object
    policy: QuantPolicy
    state: dict
    losses: list          # per-step loss
    step_ms: list         # per-step wall time, device work included
    metrics: list         # per-step metrics as floats
    start: int = 0        # the first step run (after a resume)
    telemetry_path: Optional[str] = None
    events: list = dataclasses.field(default_factory=list)  # guard events
    ckpt_ms: list = dataclasses.field(default_factory=list)  # per save


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--policy", default="hindsight",
                    choices=["hindsight", "current", "running", "dsgc",
                             "fixed", "fp32"])
    ap.add_argument("--backend", default="fused",
                    choices=["simulated", "fused"],
                    help="'fused' = the CUDA kernels (their plain versions "
                         "on the CPU; needs a static --policy: hindsight or "
                         "fixed), 'simulated' = plain fake-quant")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default="", help="append per-step JSON lines")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--telemetry", action="store_true",
                    help="per-site quantization health telemetry (clip "
                         "rate / SQNR / drift; repro_torch.telemetry)")
    ap.add_argument("--telemetry-dir", default="",
                    help="directory for the telemetry JSONL ring log "
                         "(default: --ckpt-dir or cwd)")
    ap.add_argument("--telemetry-every", type=int, default=1,
                    help="collect/log telemetry every N steps")
    ap.add_argument("--telemetry-keep", type=int, default=1024,
                    help="JSONL ring size in steps")
    ap.add_argument("--guard", action="store_true",
                    help="arm the overflow guard (implies --telemetry)")
    ap.add_argument("--guard-threshold", type=float, default=0.01,
                    help="clip-rate threshold that counts as unhealthy")
    ap.add_argument("--guard-patience", type=int, default=3,
                    help="consecutive unhealthy steps before the guard acts")
    ap.add_argument("--guard-widen", type=float, default=1.5,
                    help="range expansion factor in widen mode")
    ap.add_argument("--guard-mode", default="widen",
                    choices=list(telemetry.GUARD_MODES))
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="export a Chrome-trace JSON of the step phases "
                         "(data/compile/execute/telemetry/checkpoint) to "
                         "PATH — viewable at https://ui.perfetto.dev; "
                         "tracing is host-side only and never changes the "
                         "computation")
    args = ap.parse_args(argv)
    if args.guard:
        args.telemetry = True
    return args


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # The fp32 products of the backward (dx/dw of every contraction, the
    # attention-core backward) run in full fp32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    policy = build_policy(args.policy, args.backend, args)
    opt = adamw() if args.optimizer == "adamw" else sgdm(momentum=0.9)
    sched = cosine(args.lr, args.steps, warmup=min(20, args.steps // 10))
    state = steps_mod.init_train_state(cfg, opt, policy, seed=args.seed,
                                       device=device)
    latest = checkpoint.latest_step(args.ckpt_dir) if args.resume \
        and args.ckpt_dir else None
    if latest is not None:
        state, migrated = checkpoint.restore_migrating(args.ckpt_dir,
                                                       latest, state)
        if migrated:
            print("[train] migrated width-3 quant state to telemetry "
                  "layout")
        print(f"[train] resumed from step {state['step']}")
    start = state["step"]
    stream = data.for_arch(cfg, seq_len=args.seq, global_batch=args.batch,
                           seed=args.seed)
    train_step = steps_mod.make_train_step(cfg, policy, opt, sched,
                                           grad_accum=args.grad_accum)

    stop = {"now": False}

    def _sig(_signum, _frame):
        stop["now"] = True
    previous = {s: signal.signal(s, _sig)
                for s in (signal.SIGTERM, signal.SIGINT)}

    wd = Watchdog(args.straggler_factor)
    run = TrainRun(cfg=cfg, policy=policy, state=state, losses=[],
                   step_ms=[], metrics=[], start=start)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"policy={args.policy} backend={policy.backend} device={device} "
          f"batch={args.batch}x{args.seq}")
    logf = open(args.log, "a") if args.log else None
    sink = detector = None
    if args.telemetry:
        tdir = args.telemetry_dir or args.ckpt_dir or "."
        run.telemetry_path = os.path.join(tdir, "telemetry.jsonl")
        sink = telemetry.JsonlSink(run.telemetry_path,
                                   max_steps=args.telemetry_keep)
        detector = telemetry.GuardEventDetector(policy.telemetry, policy)
        print(f"[train] telemetry -> {run.telemetry_path} "
              f"(guard={'on' if policy.telemetry.guard else 'off'}, "
              f"mode={policy.telemetry.mode})")
    tracer = trace.Tracer(enabled=bool(args.trace))
    timer = trace.StepTimer(tracer)
    try:
        for step in range(start, args.steps):
            records = events = None
            with timer.step(step) as st:
                with st.phase("data"):
                    batch = {k: v.to(device)
                             for k, v in stream.batch(step).items()}
                    synchronize(device)
                with st.execute():   # "compile" on the first step
                    state, met = train_step(state, batch)
                    met = {k: float(v) for k, v in met.items()}  # fences
                    synchronize(device)
                if sink is not None and (step % args.telemetry_every == 0
                                         or step == args.steps - 1):
                    with st.phase("telemetry"):
                        records = telemetry.collect(state["quant"], cfg=cfg)
                        events = detector.update(step, records)
                    for ev in events:
                        tracer.instant(f"guard:{ev['action']}",
                                       site=ev["site"])
                        print(f"[guard] step {step}: {ev['action']} @ "
                              f"{ev['site']} {ev['old']} -> {ev['new']} "
                              f"(clip {100 * ev['clip_rate']:.2f}%)")
                    run.events.extend(events)
                if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                      or stop["now"]
                                      or step == args.steps - 1):
                    with st.phase("checkpoint"):
                        path = checkpoint.save(args.ckpt_dir, step + 1,
                                               state,
                                               keep_last=args.keep_last)
                    print(f"[train] checkpoint @ {step + 1}: {path}")
            phases = timer.last["phases"]
            if "checkpoint" in phases:
                run.ckpt_ms.append(phases["checkpoint"])
            # The watchdog watches the hot path (data + device step), not
            # the telemetry/checkpoint epilogue.
            dt = phases.get("compile", phases.get("execute")) / 1e3
            # How many quant sites hold a range (the first-batch rule
            # initializes each one at its first visit).
            met["inited_sites"] = inited_count(state["quant"])
            wd.step(dt, step)
            run.state = state
            run.losses.append(met["loss"])
            run.step_ms.append(dt * 1e3)
            run.metrics.append(met)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {met['loss']:.4f} "
                      f"nll {met['nll']:.4f} lr {met['lr']:.2e} "
                      f"{dt*1e3:.0f}ms, {met['inited_sites']} quant sites "
                      f"initialized")
            if logf:
                logf.write(json.dumps({"step": step, "dt": dt, **met}) + "\n")
                logf.flush()
            if records is not None:
                sink.write(step, records, events, perf=timer.perf_record(
                    items=args.batch * args.seq, unit="tokens"))
            if stop["now"]:
                print("[train] stop signal received — exiting cleanly")
                break
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
        if logf:
            logf.close()
        if sink is not None:
            sink.close()
            print(f"[train] telemetry log: {sink.path} — render with "
                  f"`python -m repro_torch.telemetry.report {sink.path}` "
                  f"(--perf for the step-phase breakdown)")
        if args.trace:
            tracer.export(args.trace)
            print(f"[train] trace: {args.trace} — load at "
                  f"https://ui.perfetto.dev")
    return run


if __name__ == "__main__":
    main()
