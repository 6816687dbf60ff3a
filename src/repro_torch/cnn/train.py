"""CNN training loop (port of ``repro/cnn/train.py``).

The paper's experimental setting: SGD + momentum 0.9 (weight decay 1e-4),
cosine schedule, a per-estimator ``QuantPolicy``, activation-range
calibration before training (paper sec. 5.2), and the one-update-per-step
range semantics shared with the LM path.  Each step's phases (data,
compile on the first step, execute, telemetry) go through the port's
``StepTimer``; ``--trace PATH`` exports them as a Chrome trace.
``--telemetry`` (or ``--guard``, which also arms the overflow guard)
writes each step's per-site quantization health, with its phase
breakdown, to the JSONL file ``--telemetry-out``.  Runs on the CUDA card
unless ``--device cpu`` is given, on the ``fused`` backend (the CUDA
kernels) unless ``--backend simulated`` is given.

Example (H100, MobileNetV2 at the Tiny ImageNet width):
  PYTHONPATH=src python -m repro_torch.cnn.train --arch mobilenetv2 \\
      --width 1.0 --image-size 64 --num-classes 200 --batch 128 \\
      --steps 3 --backend fused
CPU, reduced:
  PYTHONPATH=src python -m repro_torch.cnn.train --device cpu --steps 2 \\
      --batch 4 --image-size 16 --num-classes 4 --arch mobilenetv2
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import telemetry
from repro_torch.core import qlinear
from repro_torch.core.calibration import calibrate
from repro_torch.core.estimators import ALL_ESTIMATORS
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import inited_count
from repro_torch.data import ImageStream
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim import clip_by_global_norm, sgdm
from repro_torch.optim.schedules import cosine
from repro_torch.runtime.steps import (grads_and_stats, named_params,
                                       train_state)
from repro_torch.telemetry import trace

from . import models


def make_cnn_train_step(cfg: models.CNNConfig, policy: QuantPolicy,
                        optimizer, lr_schedule: Callable,
                        clip_norm: float = 5.0) -> Callable:
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params": ParamTree, "bn", "opt", "quant", "step"}``;
    the parameters and optimizer moments are updated in place, the BN
    running statistics and the quant tree are replaced.  Site seeds are
    ``step * 131072`` plus each site's offset, as in the reference."""
    def step_fn(state: dict, batch: dict):
        params, bn, quant, step = (state["params"], state["bn"],
                                   state["quant"], state["step"])

        def loss_of_quant(quant_in):
            loss, (new_bn, fwd_stats, met) = models.loss_fn(
                cfg, params, bn, quant_in, batch, policy, step * 131072,
                step)
            return loss, fwd_stats, (new_bn, met)

        loss, pg, stats, (new_bn, met) = grads_and_stats(loss_of_quant,
                                                         params, quant)
        pg, gnorm = clip_by_global_norm(pg, clip_norm)
        opt = optimizer.update(pg, state["opt"], named_params(params),
                               lr_schedule(step))
        del pg
        with torch.no_grad():
            new_quant = qlinear.update_quant_state(policy, quant, stats)
        return {"params": params, "bn": new_bn, "opt": opt,
                "quant": new_quant, "step": step + 1}, \
            {"loss": loss, "grad_norm": gnorm, **met}

    return step_fn


def _on(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def calibrate_cnn(cfg, params, bn, quant, policy: QuantPolicy,
                  stream: ImageStream, batches: int = 4):
    """Paper sec. 5.2: feed a few batches to warm the activation ranges
    before training (observed on 16-bit grids, so the applied error is
    negligible); batches ``10_000 + i`` of ``stream``."""
    device = quant["fc"]["act"].device

    def forward(p, batch, q, obs):
        _, (_, stats, _) = models.loss_fn(cfg, p, bn, q, batch, obs, 0, 0,
                                          train=False)
        return None, qlinear.update_quant_state(obs, q, stats)

    return calibrate(forward, params, quant,
                     (_on(stream.batch(10_000 + i), device)
                      for i in range(batches)), policy)


@dataclasses.dataclass
class CNNRun:
    """What one :func:`train_cnn` run produced."""

    cfg: models.CNNConfig
    policy: QuantPolicy
    state: dict
    acc: float            # mean eval accuracy after training
    history: list         # per-step metrics as floats (+ step_ms, inited)


def train_cnn(cfg: models.CNNConfig, policy: QuantPolicy, *, steps: int,
              batch: int, lr: float = 0.05, seed: int = 0,
              calibration_batches: int = 2, eval_batches: int = 4,
              lr_schedule=None, telemetry_sink=None,
              trace_path: Optional[str] = None, device=None) -> CNNRun:
    """Calibrate, train ``steps`` steps on the synthetic ``ImageStream``
    and evaluate ``eval_batches`` batches; returns a :class:`CNNRun`.

    ``telemetry_sink``: any object with ``write(step, records,
    perf=...)`` (``telemetry.JsonlSink``, ``MemorySink``); with a
    telemetry-enabled policy it gets the per-site records collected from
    the quant state after every step, and the step's phase breakdown.

    ``trace_path``: export a Chrome-trace JSON of the step phases (data /
    compile / execute) to this path — host-side timing only, the
    computation is unchanged.  Each step's ``step_ms`` is its compile or
    execute phase, fenced by a host read of the metrics and a
    synchronize."""
    device = resolve_device(device)
    params, bn = models.init(cfg, seed=seed, device=device)
    quant = models.init_sites(cfg, policy, device=device)
    opt = sgdm(momentum=0.9, weight_decay=1e-4)
    sched = lr_schedule or cosine(lr, steps, warmup=max(1, steps // 20))
    stream = ImageStream(cfg.num_classes, cfg.image_size, cfg.channels,
                         batch, seed=seed)

    if policy.enabled and policy.quantize_acts and calibration_batches:
        quant = calibrate_cnn(cfg, params, bn, quant, policy, stream,
                              calibration_batches)

    state = dict(train_state(params, quant, opt), bn=bn)
    step_fn = make_cnn_train_step(cfg, policy, opt, sched)
    timer = trace.StepTimer(trace.Tracer(enabled=bool(trace_path)))

    collect = telemetry_sink is not None and policy.telemetry.enabled
    history = []
    for s in range(steps):
        records = None
        with timer.step(s) as st:
            with st.phase("data"):
                b = _on(stream.batch(s), device)
                synchronize(device)
            with st.execute():   # "compile" on the first step
                state, met = step_fn(state, b)
                met = {k: float(v) for k, v in met.items()}   # fences
                synchronize(device)
            if collect:
                with st.phase("telemetry"):
                    records = telemetry.collect(state["quant"])
        phases = timer.last["phases"]
        met["step_ms"] = phases.get("compile", phases.get("execute"))
        met["inited_sites"] = inited_count(state["quant"])
        history.append(met)
        if records is not None:
            telemetry_sink.write(s, records, perf=timer.perf_record(
                items=batch, unit="images"))
    if trace_path:
        timer.tracer.export(trace_path)

    with torch.no_grad():
        accs = []
        for i in range(eval_batches):
            b = _on(stream.batch(50_000 + i), device)
            logits, _, _ = models.apply_cfg(
                cfg, state["params"], state["bn"], state["quant"],
                b["images"], policy, 0, state["step"], train=False)
            accs.append(float((torch.argmax(logits, -1) == b["labels"])
                              .to(torch.float32).mean()))
    acc = sum(accs) / len(accs) if accs else float("nan")
    return CNNRun(cfg=cfg, policy=policy, state=state, acc=acc,
                  history=history)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="resnet18",
                    choices=["resnet18", "vgg16", "mobilenetv2"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibration-batches", type=int, default=2)
    ap.add_argument("--policy", default="hindsight",
                    choices=list(ALL_ESTIMATORS) + ["fp32"])
    ap.add_argument("--backend", default="fused",
                    choices=["simulated", "fused"],
                    help="execution backend for the quantization sites "
                         "(incl. the int8 conv contraction): 'fused' = the "
                         "CUDA kernels via im2col (their plain versions on "
                         "the CPU; requires a fully-static --policy, i.e. "
                         "hindsight or fixed), 'simulated' = plain "
                         "fake-quant + a float64 conv")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-site quantization health telemetry")
    ap.add_argument("--telemetry-out", default="",
                    help="telemetry JSONL path (default: telemetry.jsonl "
                         "in the cwd)")
    ap.add_argument("--guard", action="store_true",
                    help="arm the overflow guard (implies --telemetry)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="export a Chrome-trace JSON of the step phases "
                         "to PATH (view at https://ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.guard:
        args.telemetry = True
    return args


def main(argv=None) -> CNNRun:
    """CLI driver for the CNN path (parity with ``launch.train``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.policy == "fp32":
        policy = QuantPolicy.disabled()
    else:
        policy = QuantPolicy.w8a8g8(act_kind=args.policy,
                                    grad_kind=args.policy)
    if args.telemetry:
        policy = policy.with_telemetry(guard=args.guard)
    # Raises for illegal combinations (a dynamic estimator on 'fused').
    policy = policy.with_backend(args.backend)
    cfg = models.bench_config(args.arch, num_classes=args.num_classes,
                              width=args.width, image_size=args.image_size)
    sink = None
    if args.telemetry:
        sink = telemetry.JsonlSink(args.telemetry_out or "telemetry.jsonl")
        print(f"[cnn.train] telemetry -> {sink.path}")
    try:
        run = train_cnn(cfg, policy, steps=args.steps, batch=args.batch,
                        lr=args.lr, seed=args.seed,
                        calibration_batches=args.calibration_batches,
                        telemetry_sink=sink, trace_path=args.trace or None,
                        device=device)
    finally:
        if sink is not None:
            sink.close()
    if args.trace:
        print(f"[cnn.train] trace: {args.trace} — load at "
              f"https://ui.perfetto.dev")
    for i, met in enumerate(run.history):
        if i % 10 == 0 or i == len(run.history) - 1:
            print(f"[cnn.train] step {i:4d} "
                  + " ".join(f"{k} {v:.4f}" for k, v in met.items()))
    print(f"[cnn.train] arch={cfg.name} policy={args.policy} "
          f"backend={policy.backend} device={device} "
          f"final_eval_acc={run.acc:.4f}")
    return run


if __name__ == "__main__":
    main()
