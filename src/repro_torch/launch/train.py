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
compile on the first step, execute) to PATH.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import statistics

import torch

from repro_torch import configs, data
from repro_torch.core.estimators import ALL_ESTIMATORS
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import inited_count
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim import adamw, sgdm
from repro_torch.optim.schedules import cosine
from repro_torch.runtime import steps as steps_mod
from repro_torch.telemetry import trace


def build_policy(kind: str, backend: str) -> QuantPolicy:
    if kind == "fp32":
        return QuantPolicy.disabled()
    if kind not in ALL_ESTIMATORS:
        raise ValueError(f"unknown policy {kind!r}")
    # Raises for illegal combinations (a dynamic estimator on 'fused').
    return QuantPolicy.w8a8g8(act_kind=kind, grad_kind=kind, backend=backend)


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
    ap.add_argument("--log", default="", help="append per-step JSON lines")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="export a Chrome-trace JSON of the step phases "
                         "(data/compile/execute) to PATH — viewable at "
                         "https://ui.perfetto.dev; tracing is host-side "
                         "only and never changes the computation")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # The fp32 products of the backward (dx/dw of every contraction, the
    # attention-core backward) run in full fp32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    policy = build_policy(args.policy, args.backend)
    opt = adamw() if args.optimizer == "adamw" else sgdm(momentum=0.9)
    sched = cosine(args.lr, args.steps, warmup=min(20, args.steps // 10))
    state = steps_mod.init_train_state(cfg, opt, policy, seed=args.seed,
                                       device=device)
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
                   step_ms=[], metrics=[])
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"policy={args.policy} backend={policy.backend} device={device} "
          f"batch={args.batch}x{args.seq}")
    logf = open(args.log, "a") if args.log else None
    timer = trace.StepTimer(trace.Tracer(enabled=bool(args.trace)))
    try:
        for step in range(args.steps):
            with timer.step(step) as st:
                with st.phase("data"):
                    batch = {k: v.to(device)
                             for k, v in stream.batch(step).items()}
                    synchronize(device)
                with st.execute():   # "compile" on the first step
                    state, met = train_step(state, batch)
                    met = {k: float(v) for k, v in met.items()}  # fences
                    synchronize(device)
            phases = timer.last["phases"]
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
            if stop["now"]:
                print("[train] stop signal received — exiting cleanly")
                break
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
        if logf:
            logf.close()
        if args.trace:
            timer.tracer.export(args.trace)
            print(f"[train] trace: {args.trace} — load at "
                  f"https://ui.perfetto.dev")
    return run


if __name__ == "__main__":
    main()
