"""Batched serving driver: quantized prefill + decode with static ranges
(port of ``repro/launch/serve.py``).

In-hindsight ranges double as static inference quantization ranges:
every activation quantizer runs single-pass static once its leaf is
initialized.  ``--backend fused`` (the default) runs the quantizers, the
int8 projections and the prefill attention core on the hand-written CUDA
kernels; ``--backend simulated`` runs the plain PyTorch fake-quant path
(``launch/train.py``'s meaning of the flag).  The KV cache is bf16, or
int8 with ``--int8-cache``.  Runs on the CUDA card unless ``--device cpu``
is given.

Example (H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --batch 4 --prompt-len 1024 --gen 32
CPU, reduced:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
      --reduced --batch 2 --prompt-len 16 --gen 4 --device cpu

``--trace PATH`` exports a Chrome-trace JSON of the serving phases (the
prefill, each decode step) to PATH.  ``--ckpt-dir`` serves the trained
parameters and calibrated ranges of the newest checkpoint there (a
failed restore serves from init, with a traceback under ``--verbose``);
``--telemetry PATH`` writes the prefill's per-site quantization health as
one JSONL line.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import traceback
from typing import Optional

import torch

from repro_torch import checkpoint, configs, data, telemetry
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import model
from repro_torch.telemetry import trace


@dataclasses.dataclass
class ServeRun:
    """What one serve run produced (returned by :func:`main`)."""

    cfg: object
    policy: QuantPolicy
    params: object
    quant_state: dict
    prompt: torch.Tensor            # [B, prompt_len] token ids
    tokens: torch.Tensor            # [B, gen] generated ids
    prefill_logits: torch.Tensor    # [B, V] logits of the last prompt token
    prefill_stats: dict             # forward stats tree of the prefill
    prefill_ms: float
    decode_ms: float
    decode_tok_s: float
    # the prompt batch: "tokens" and the frontend's "frames" / "patches"
    inputs: dict = dataclasses.field(default_factory=dict)
    cache_len: int = 0
    pos0: int = 0                   # the first decode step's position


def generate(params, quant_state, prompt, cfg, policy: QuantPolicy,
             gen: int, tracer: Optional[trace.Tracer] = None, *,
             cache_len: Optional[int] = None,
             pos0: Optional[int] = None) -> ServeRun:
    """Prefill ``prompt`` (a token tensor ``[B, S]``, or a batch dict of
    ``"tokens"`` and the frontend's ``"frames"`` / ``"patches"``) and
    greedily decode ``gen`` tokens, the first at position ``pos0``
    (default: the positions the prefill filled), into a cache of
    ``cache_len`` slots (default: those positions plus ``gen``; an
    enc-dec cross cache of ``cfg.enc_len(cache_len)`` slots keeps the
    last frames of a longer source).  With an enabled ``tracer``, one
    span for the prefill (the first one carries the kernels' build) and
    one per decode step, each fenced."""
    tracer = tracer or trace.get_tracer()
    inputs = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    tokens = inputs["tokens"]
    device = tokens.device
    b, prompt_len = tokens.shape
    filled = prompt_len + (inputs["patches"].shape[1]
                           if "patches" in inputs else 0)
    cache_len = cache_len or filled + gen
    pos0 = filled if pos0 is None else pos0
    synchronize(device)
    t0 = time.perf_counter()
    with tracer.span("prefill (compile+execute)", batch=b,
                     prompt_len=prompt_len):
        logits, caches, stats = model.prefill(
            params, quant_state, inputs, cfg, policy, cache_len=cache_len,
            return_stats=True)
        synchronize(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    with tracer.span("decode", steps=gen - 1):
        for i in range(gen - 1):
            with tracer.span("decode step", pos=pos0 + i):
                pos = torch.full((b,), pos0 + i, dtype=torch.int64,
                                 device=device)
                logits, caches = model.decode_step(params, quant_state, tok,
                                                   pos, caches, cfg, policy)
                tok = torch.argmax(logits, dim=-1)[:, None]
                if tracer.enabled:   # fence per span only when tracing
                    synchronize(device)
            out.append(tok)
        synchronize(device)
    t_decode = time.perf_counter() - t0
    return ServeRun(
        cfg=cfg, policy=policy, params=params, quant_state=quant_state,
        prompt=tokens, tokens=torch.cat(out, dim=1),
        prefill_logits=prefill_logits, prefill_stats=stats,
        prefill_ms=t_prefill * 1e3, decode_ms=t_decode * 1e3,
        decode_tok_s=(gen - 1) * b / max(t_decode, 1e-9), inputs=inputs,
        cache_len=cache_len, pos0=pos0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--policy", default="hindsight",
                    choices=["hindsight", "fp32"])
    ap.add_argument("--backend", default="fused",
                    choices=["simulated", "fused"])
    ap.add_argument("--int8-cache", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="restore trained params + calibrated ranges")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true",
                    help="full tracebacks on restore failure")
    ap.add_argument("--telemetry", default="", metavar="PATH",
                    help="write per-site prefill quantization health "
                         "(clip/SQNR/util) as JSONL to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="export a Chrome-trace JSON of the serving phases "
                         "(prefill / per-step decode / telemetry) to PATH — "
                         "view at https://ui.perfetto.dev")
    return ap.parse_args(argv)


def main(argv=None) -> ServeRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # fp32 products outside the int8 sites (logits, decode attention) run
    # in full fp32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    if args.int8_cache:
        cfg = dataclasses.replace(cfg, cache_dtype="int8")
    policy = QuantPolicy.disabled() if args.policy == "fp32" \
        else QuantPolicy.w8a8g8(backend=args.backend)
    if args.telemetry:
        policy = policy.with_telemetry()

    params = model.init_params(cfg, seed=args.seed, device=device)
    quant_state = model.init_quant_state(cfg, policy, device=device)
    if args.ckpt_dir:
        try:
            step = checkpoint.latest_step(args.ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in "
                                        f"{args.ckpt_dir!r}")
            st, migrated = checkpoint.restore_migrating(
                args.ckpt_dir, step, {"params": params,
                                      "quant": quant_state})
            params, quant_state = st["params"], st["quant"]
            if migrated:
                print("[serve] migrated width-3 quant state to telemetry "
                      "layout")
            print(f"[serve] restored step {step}")
        except Exception as e:      # serving goes on from init
            if args.verbose:
                traceback.print_exc()
            print(f"[serve] restore failed ({e}); serving from init")
    stream = data.for_arch(cfg, seq_len=args.prompt_len + args.gen,
                           global_batch=args.batch, seed=args.seed)
    batch = stream.batch(0)
    prompt = {k: (v[:, :args.prompt_len] if k == "tokens" else v).to(device)
              for k, v in batch.items() if k in ("tokens", "frames",
                                                 "patches")}
    # As the reference's driver: the VLM's cache and first decode
    # position count n_patches beyond the prompt length, although its
    # text stream is already n_patches short, so decode starts past
    # positions the prefill never filled (n_patches - gen of them).
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    tracer = trace.Tracer(enabled=bool(args.trace))
    run = generate(params, quant_state, prompt, cfg, policy, args.gen,
                   tracer, cache_len=args.prompt_len + args.gen + extra,
                   pos0=args.prompt_len + extra)
    if args.telemetry:
        with tracer.span("telemetry flush"):
            sink = telemetry.JsonlSink(args.telemetry, max_steps=1024)
            sink.write(0, telemetry.collect(run.prefill_stats, cfg=cfg))
            sink.close()
        print(f"[serve] prefill telemetry -> {args.telemetry} — render with "
              f"`python -m repro_torch.telemetry.report {args.telemetry}`")
    print(f"[serve] arch={cfg.name} policy={args.policy} "
          f"backend={policy.backend} cache={cfg.cache_dtype} "
          f"device={device}")
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{run.prefill_ms:.1f} ms")
    print(f"[serve] decode  {args.gen - 1} steps: {run.decode_ms:.1f} ms "
          f"({run.decode_tok_s:.1f} tok/s)")
    print(f"[serve] sample tokens[0]: {run.tokens[0][:12].tolist()}")
    if args.trace:
        tracer.export(args.trace)
        print(f"[serve] trace: {args.trace} — load at "
              f"https://ui.perfetto.dev")
    return run


if __name__ == "__main__":
    main()
