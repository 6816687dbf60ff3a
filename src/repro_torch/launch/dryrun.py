"""Multi-pod dry run: trace one rank's program of every (arch x shape x
mesh) cell (port of ``repro/launch/dryrun.py``).

The reference proves its distribution config coherent without the
hardware by compiling each cell for 512 placeholder devices.  The port
has one controller per rank, so it runs rank 0's own program with no
storage behind it: every tensor is a ``FakeTensor`` (shape, dtype and
device, no data) and the process group is ``torch.distributed``'s
``"fake"`` backend at the mesh's world size (256 for ``(data 16, model
16)``, 512 for ``(pod 2, data 16, model 16)``), whose collectives
return at once.  A full-width model then costs only host time.  The
state is built through the port's own entry points (``init_train_state``
and ``sharding.store_state`` for ``--fsdp 2d``, the model-axis shards
alone for ``--fsdp tp``; ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on the mesh's groups, ``launch.mesh.mesh_groups``),
and one step runs under ``launch.op_cost.CostMode``, whose counts are
the record's roofline terms.  Rank 0 holds ``sharding.split_range``'s
largest share of every uneven split, so its program is the costliest
rank's.

The policy is built as the reference's dry run builds it, on the
``simulated`` backend, the default of both packages: the reference
compiles that backend too, and a fake tensor cannot enter a kernel
launch.

Host reads.  A fake tensor has no value, but the port reads flags to the
host (``bool(leaf[INITED] > 0.5)`` at a quant site).  :class:`SteadyState`
answers each with the steady state of a step after the first (every leaf
inited; :data:`READ_RULES`) and counts the reads by site (the record's
``host_reads``); a read no rule answers raises.  The state's step count
is 1 for the same reason.

Memory.  ``argument_size_in_bytes`` is the rank's state and its rows of
the batch (the train step is handed the global batch and takes its
rows); ``stored_state_bytes`` the part of it that is parameters and
optimizer moments.  ``temp_size_in_bytes`` is the peak of live storage
bytes during the step (``CostMode``) less the arguments and less the
outputs that do not alias an argument, so that ``per_device_bytes_est``,
the reference's sum of the four, is that peak as the rank would see it.
``output_size_in_bytes`` / ``alias_size_in_bytes`` are the outputs' and
those that reuse an argument's storage (the in-place optimizer update,
the decode cache).  There is no time and no rate: the roofline terms
are the reader's work (``launch.mesh`` carries no chip constants).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multipod
    python -m repro_torch.launch.dryrun --all --both-meshes  # one
                                                   # subprocess per cell
Add ``--device cpu`` on a host without a card (the ``cuda`` trace, the
default, needs one: its generators live there).  ``--layers N`` cuts the
depth, ``--mesh PxDxM`` (or ``DxM``) replaces the production mesh.
Outputs one JSON per cell under --out (default experiments/dryrun_torch/).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import linecache
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.op_cost import CostMode, count_bytes, leaves
from repro_torch.models import model
from repro_torch.optim import adamw, sgdm
from repro_torch.optim.schedules import cosine
from repro_torch.runtime import sharding, steps

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Parameter counts.
# ---------------------------------------------------------------------------
def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def count_params(params) -> int:
    return int(sum(p.numel() for p in _named(params).values()))


def moe_inactive_params(cfg, params) -> int:
    """Parameters in routed experts that a single token does NOT touch."""
    if cfg.moe is None:
        return 0
    total = 0
    for name, leaf in _named(params).items():
        p = name.replace(".", "/")
        if "/moe/" in p and "shared" not in p and \
                p.rsplit("/", 1)[-1] in ("w_up", "w_gate", "w_down"):
            total += leaf.numel()
    frac = 1.0 - cfg.moe.top_k / cfg.moe.n_experts
    return int(total * frac)


# ---------------------------------------------------------------------------
# Host reads: the steady state of a step after the first.
# ---------------------------------------------------------------------------
# (module path under repro_torch, function, a fragment of the source line)
# -> the value the read gets.  The simulated backend without telemetry,
# under the dry run's policies, reads one flag: whether a hindsight leaf
# is inited (the fused backend's reads sit behind its kernel launches,
# the guard's and dsgc's behind telemetry and the dsgc policy).
READ_RULES = {
    ("core/estimators.py", "reads_current", "leaf[INITED] > 0.5"): True,
}


class UnansweredRead(RuntimeError):
    """A host read of a fake tensor that no rule of :data:`READ_RULES`
    answers."""


def _site() -> tuple:
    """``(module path, function, source line, line number)`` of the
    innermost frame of the port's code outside this module."""
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG + os.sep) and fn != here and \
                os.sep + "launch" + os.sep + "op_cost.py" not in fn:
            rel = os.path.relpath(fn, _PKG).replace(os.sep, "/")
            line = linecache.getline(fn, f.f_lineno).strip()
            return rel, f.f_code.co_name, line, f.f_lineno
        f = f.f_back
    return "?", "?", "", 0


class SteadyState(CostMode):
    """:class:`~repro_torch.launch.op_cost.CostMode` that answers the
    host reads of fake tensors (``_local_scalar_dense``) that the fake
    mode cannot answer itself, by :data:`READ_RULES`.  ``reads`` counts
    the reads at the rules' sites, answered or (around a real run) read,
    with the first value each site got."""

    def __init__(self):
        super().__init__()
        self.reads: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten._local_scalar_dense.default:
            return super().__torch_dispatch__(func, types, args, kwargs)
        from torch._subclasses.fake_tensor import \
            DataDependentOutputException
        try:
            value, answer = super().__torch_dispatch__(func, types, args,
                                                       kwargs), False
        except DataDependentOutputException:
            value, answer = None, True
        rel, fn, line, lineno = _site()
        rule = next(((frag, v) for (r_rel, r_fn, frag), v in
                     READ_RULES.items()
                     if r_rel == rel and r_fn == fn and frag in line), None)
        if rule is None:
            if answer:
                raise UnansweredRead(f"a host read at {rel}:{lineno} ({fn}: "
                                     f"{line!r}) has no steady-state rule")
            return value
        if answer:
            value = rule[1]
            self._count(func, args, kwargs, value)
        hit = self.reads.setdefault(f"{rel}:{fn}: {rule[0]}",
                                    {"answer": value, "count": 0})
        hit["count"] += 1
        return value


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------
def mesh_shape(multi_pod: bool, mesh: Optional[str] = None) -> tuple:
    """``(pod, data, model)`` of the production mesh, or of ``mesh``
    (``"PxDxM"`` or ``"DxM"``)."""
    if mesh:
        dims = tuple(int(v) for v in mesh.split("x"))
        return dims if len(dims) == 3 else (1,) + dims
    return (2, 16, 16) if multi_pod else (1, 16, 16)


def mesh_name(shape: tuple) -> str:
    return "x".join(str(v) for v in (shape if shape[0] > 1 else shape[1:]))


def batch_rows(n: int, groups) -> tuple:
    """``(start, count)`` of the rank's rows of a global batch of ``n``
    (``sharding.batch_pspecs``' rule over ``(pod, data)``: the whole
    batch where the ranks do not divide it)."""
    world = dist.get_world_size(groups.batch)
    if world > 1 and n % world == 0:
        c = n // world
        return dist.get_rank(groups.batch) * c, c
    return 0, n


def make_inputs(spec: dict, device, rows: Optional[tuple] = None) -> dict:
    """Tensors of ``configs.input_specs``' shapes and dtypes on
    ``device`` (zeros; the loss mask ones), cut to ``rows`` of dim 0."""
    out = {}
    for k, m in spec.items():
        shape = list(m.shape)
        if rows is not None and shape:
            shape[0] = rows[1]
        fill = torch.ones if k == "mask" else torch.zeros
        out[k] = fill(shape, dtype=m.dtype, device=device)
    return out


def build_cell(cfg, shape, groups, policy: QuantPolicy, *, fsdp: str = "2d",
               grad_accum: Optional[int] = None, device="cuda",
               seq_shard: bool = False):
    """``(fn, args, state)``: the cell's step on the rank of ``groups``
    (``launch.mesh.mesh_groups``) and its arguments, ``state`` the
    rank's train state or ``{"params", "quant"}`` (plus ``"cache"``) of
    a serving cell.  Fake tensors where a ``FakeTensorMode`` is active,
    real ones otherwise.  ``seq_shard``: the step factories' (the
    sequence-parallel residual on the model axis)."""
    spec = configs.input_specs(cfg, shape)
    rows = batch_rows(shape.global_batch, groups)
    stored = fsdp == "2d"

    def cut(params):
        if stored:
            return sharding.store_params(params, groups.coords, groups.sizes)
        return sharding.shard_params(params, groups.coords, groups.sizes)

    if shape.kind == "train":
        opt = sgdm(momentum=0.9) if cfg.optimizer == "sgdm" else adamw()
        accum = grad_accum or cfg.grad_accum_for(shape.name)
        st = steps.init_train_state(cfg, opt, policy, seed=0, device=device)
        if stored:
            st = sharding.store_state(st, groups.coords, groups.sizes)
        else:
            st = steps.train_state(cut(st["params"]), st["quant"], opt)
        st["step"] = 1
        if isinstance(st["opt"], dict) and "count" in st["opt"]:
            st["opt"]["count"] = 1
        fn = steps.make_train_step(
            cfg, policy, opt, cosine(3e-4, 10000, warmup=100),
            grad_accum=accum, group=groups.batch, model_group=groups.model,
            storage_group=groups.data if stored else None,
            pod_group=groups.pod if stored else None, seq_shard=seq_shard)
        return fn, (st, make_inputs(spec, device)), st

    params = cut(model.init_params(cfg, seed=0, device=device))
    quant = model.init_quant_state(cfg, policy, device=device)
    batch = make_inputs(spec, device, rows)
    group = groups.data if stored else None
    if shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, policy, cache_len=shape.seq_len,
                                     model_group=groups.model, group=group,
                                     seq_shard=seq_shard)
        return fn, (params, quant, batch), {"params": params, "quant": quant}
    with sharding.model_parallel(groups.model):
        cache = model.init_cache(cfg, rows[1], shape.seq_len, device)
    batch["pos"].fill_(shape.seq_len - 1)
    fn = steps.make_decode_step(cfg, policy, model_group=groups.model,
                                group=group, seq_shard=seq_shard)
    return fn, (params, quant, batch, cache), \
        {"params": params, "quant": quant, "cache": cache}


def stored_state_bytes(state: dict) -> int:
    """Bytes of a train state's parameters and optimizer moments (a
    serving cell's parameters)."""
    ts = list(_named(state["params"]).values())
    opt = state.get("opt")
    if isinstance(opt, dict):
        ts += [t for v in opt.values() if isinstance(v, dict)
               for t in v.values() if isinstance(t, torch.Tensor)]
    return count_bytes(ts)


def _batch_bytes(batch: dict, rows: tuple, n: int) -> int:
    """The bytes of the rank's rows of a batch (a global batch of ``n``
    rows, or the rank's own)."""
    return sum(t.numel() * t.element_size() * rows[1] // n
               if t.dim() and t.shape[0] == n else
               t.numel() * t.element_size() for t in batch.values())


def memory_record(mode: CostMode, state: dict, batch: dict, out,
                  held: int, arg_keys: set, rows: tuple, n: int) -> dict:
    """The record's ``memory`` (module docstring)."""
    outs = leaves(out)
    out_b = count_bytes(outs)
    alias_b = count_bytes(t for t in outs
                          if id(t.untyped_storage()) in arg_keys)
    arg = count_bytes(leaves(state)) + _batch_bytes(batch, rows, n)
    temp = max(mode.peak_bytes - held - (out_b - alias_b), 0)
    return {"argument_size_in_bytes": int(arg),
            "stored_state_bytes": int(stored_state_bytes(state)),
            "output_size_in_bytes": int(out_b),
            "temp_size_in_bytes": int(temp),
            "alias_size_in_bytes": int(alias_b),
            "per_device_bytes_est": int(arg + temp + out_b - alias_b)}


def trace_step(fn, args, state, batch, rows, n, mode: CostMode) -> tuple:
    """One call of ``fn(*args)`` under ``mode``: ``(cost record, memory
    record)``."""
    with mode:
        held = mode.hold(args)
        arg_keys = mode.storages(args)
        out = fn(*args)
        mem = memory_record(mode, state, batch, out, held, arg_keys, rows, n)
    return mode.result(), mem


def _policy(policy_kind: str, int8_gather: bool) -> QuantPolicy:
    if policy_kind == "fp32":
        policy = QuantPolicy.disabled()
    else:
        policy = QuantPolicy.w8a8g8(act_kind=policy_kind,
                                    grad_kind=policy_kind)
    if int8_gather:
        policy = dataclasses.replace(policy, int8_weight_gather=True)
    return policy


def cut_depth(cfg, layers: Optional[int]):
    """``cfg`` with ``layers`` decoder (and encoder) layers."""
    if not layers:
        return cfg
    kw = {"n_layers": layers}
    if cfg.enc_layers:
        kw["enc_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def depth_unit(cfg) -> Optional[int]:
    """The layers of one repeat of the stack's pattern (the encoder's
    and the decoder's together), or None where the stack does not repeat
    one unit (an encoder of another depth or pattern length)."""
    p = len(cfg.pattern)
    if cfg.enc_layers and (cfg.enc_layers != cfg.n_layers
                           or len(cfg.enc_pattern) != p):
        return None
    return p


@contextlib.contextmanager
def fake_mesh(dims: tuple):
    """Rank 0's groups (``launch.mesh.mesh_groups``) of the mesh ``dims``
    (``(pod, data, model)``) under a fake process group of its world
    size, destroyed on every exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group: "
                           "a default group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=dims[0] * dims[1] * dims[2])
    try:
        yield mesh_mod.mesh_groups(dims[1], dims[2], dims[0])
    finally:
        dist.destroy_process_group()


def trace_cell(cfg, shape, dims: tuple, policy: QuantPolicy, *,
               fsdp: str = "2d", grad_accum=None, device="cuda",
               seq_shard: bool = False) -> dict:
    """One trace of rank 0's step on the mesh ``dims`` (:func:`fake_mesh`):
    ``{"cost", "memory", "reads", "coords"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mesh(dims) as groups, FakeTensorMode():
        fn, args, state = build_cell(cfg, shape, groups, policy, fsdp=fsdp,
                                     grad_accum=grad_accum, device=device,
                                     seq_shard=seq_shard)
        reads = SteadyState()
        cost, mem = trace_step(fn, args, state, _batch_of(shape, args),
                               batch_rows(shape.global_batch, groups),
                               shape.global_batch, reads)
        return {"cost": cost, "memory": mem, "reads": reads.reads,
                "coords": dict(groups.coords)}


def _batch_of(shape, args) -> dict:
    return args[1] if shape.kind == "train" else args[2]


def _extrapolate(lo, hi, steps: int):
    """``lo + steps * (hi - lo)`` through nested dicts of numbers."""
    if isinstance(lo, dict):
        return {k: _extrapolate(v, hi[k], steps) for k, v in lo.items()}
    if isinstance(lo, bool) or not isinstance(lo, (int, float)):
        return lo
    return lo + steps * (hi - lo)


def extrapolated_trace(cfg, shape, dims, policy, **kw) -> tuple:
    """:func:`trace_cell` at full depth from two traces of a cut depth,
    ``(trace, traced depths)``.  Every layer of a pattern unit dispatches
    the same ops on the same shapes, so each count grows by the same
    amount a unit; so do the step's peak live bytes past the first unit
    (its layers' saved inputs and caches add up unit by unit, while the
    first unit's peak lacks the garbage a later one finds).  The traces
    at ``2 u + r`` and ``3 u + r`` layers (``u`` the unit, ``r`` the
    depth's remainder) give that amount, and the full depth adds ``(L -
    2 u - r) / u`` units to the first.  The arguments are the full-depth
    state's, counted exactly.  Where the stack is shallower than four
    units, or does not repeat one unit, the full depth is traced."""
    depth, unit = cfg.n_layers, depth_unit(cfg)
    if unit is None or depth < 4 * unit:
        return trace_cell(cfg, shape, dims, policy, **kw), [depth]
    k1 = 2 * unit + depth % unit
    lo = trace_cell(cut_depth(cfg, k1), shape, dims, policy, **kw)
    hi = trace_cell(cut_depth(cfg, k1 + unit), shape, dims, policy, **kw)
    out = _extrapolate(lo, hi, (depth - k1) // unit)
    mem = out["memory"]
    mem.update(_state_bytes(cfg, shape, dims, policy, **kw))
    mem["per_device_bytes_est"] = mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"] + mem["output_size_in_bytes"] - \
        mem["alias_size_in_bytes"]
    return out, [k1, k1 + unit]


def _state_bytes(cfg, shape, dims, policy, *, fsdp="2d", grad_accum=None,
                 device="cuda", seq_shard=False) -> dict:
    """The rank's ``argument_size_in_bytes`` and ``stored_state_bytes``,
    from its state built (fake) without a step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mesh(dims) as groups, FakeTensorMode():
        _, args, state = build_cell(cfg, shape, groups, policy, fsdp=fsdp,
                                    grad_accum=grad_accum, device=device,
                                    seq_shard=seq_shard)
        rows = batch_rows(shape.global_batch, groups)
        return {"argument_size_in_bytes": count_bytes(leaves(state))
                + _batch_bytes(_batch_of(shape, args), rows,
                               shape.global_batch),
                "stored_state_bytes": stored_state_bytes(state)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             policy_kind: str = "hindsight", fsdp: str = "2d",
             grad_accum=None, tag: str = "", seq_shard: bool = False,
             int8_gather: bool = False, device: str = "cuda",
             layers: Optional[int] = None, mesh: Optional[str] = None,
             extrapolate: bool = False, batch: Optional[int] = None,
             seq: Optional[int] = None) -> dict:
    """Trace rank 0's step of one cell and write its record.  ``layers``
    cuts the depth; ``batch`` / ``seq`` set the shape's global batch and
    sequence.  ``extrapolate``: the full depth from two cut depths
    (:func:`extrapolated_trace`).  ``seq_shard``: the residual stream as
    the rank's rows of the sequence (the step factories' flag)."""
    cfg = cut_depth(configs.get(arch), layers)
    shape = configs.SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    dims = mesh_shape(multi_pod, mesh)
    ok, why = cfg.supports(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(dims),
           "policy": policy_kind, "fsdp": fsdp, "tag": tag,
           "seq_shard": seq_shard, "grad_accum_override": grad_accum,
           "device": device, "layers": cfg.n_layers,
           "layers_cut": bool(layers), "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "world": dims[0] * dims[1] * dims[2]}
    if not ok:
        rec.update(status="skipped", reason=why)
        return _write(rec, out_dir)
    policy = _policy(policy_kind, int8_gather)
    kw = dict(fsdp=fsdp, grad_accum=grad_accum, device=device,
              seq_shard=seq_shard)
    t0 = time.time()
    if extrapolate:
        tr, traced = extrapolated_trace(cfg, shape, dims, policy, **kw)
    else:
        tr, traced = trace_cell(cfg, shape, dims, policy, **kw), \
            [cfg.n_layers]
    rec["traced_layers"] = traced
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = model.init_params(cfg, seed=0, device=device)
        n_params = count_params(params)
        n_active = n_params - moe_inactive_params(cfg, params)
        del params
    cost = tr["cost"]
    rec["coords"] = tr["coords"]
    rec["memory"] = tr["memory"]
    rec["cost"] = {k: cost[k] for k in ("flops", "bytes_accessed",
                                        "transcendentals")}
    rec["n_ops"] = cost["n_ops"]
    rec["collectives"] = dict(cost["collectives"])
    rec["collectives"]["total_operand_bytes"] = \
        cost["collective_operand_bytes"]
    rec["collectives"]["total_ops"] = cost["collective_ops"]
    rec["host_reads"] = tr["reads"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    rec["model"] = {
        "n_params": n_params, "n_active_params": n_active,
        "tokens_per_step": tokens,
        "model_flops": float(factor * n_active * tokens),
    }
    rec.update(status="ok", trace_s=round(time.time() - t0, 2))
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x', '_')}"
            + (f"__{rec['tag']}" if rec.get("tag") else "") + ".json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _cell_cmd(args, arch: str, shape: str, mp: bool) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", args.out,
           "--policy", args.policy, "--fsdp", args.fsdp, "--tag", args.tag,
           "--device", args.device]
    if mp:
        cmd.append("--multipod")
    for flag, v in (("--grad-accum", args.grad_accum),
                    ("--layers", args.layers), ("--mesh", args.mesh),
                    ("--batch", args.batch), ("--seq", args.seq)):
        if v:
            cmd += [flag, str(v)]
    for flag, on in (("--int8-gather", args.int8_gather),
                     ("--extrapolate", args.extrapolate),
                     ("--seq-shard", args.seq_shard)):
        if on:
            cmd.append(flag)
    return cmd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", help="with --all: that shape's cells only")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="with --all: run single-pod AND multi-pod")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--policy", default="hindsight",
                    choices=["hindsight", "current", "running", "fp32"])
    ap.add_argument("--fsdp", default="2d", choices=["2d", "tp"])
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--int8-gather", action="store_true",
                    help="pin FSDP weight all-gathers to the int8 tensor")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-SP: the residual stream's sequence dim "
                         "over the model axis (records tagged seq_shard "
                         "unless --tag is given)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda needs a card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--mesh", default=None,
                    help="PxDxM or DxM in place of the production mesh")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch in place of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length in place of its own")
    ap.add_argument("--extrapolate", action="store_true",
                    help="the full depth from traces of two cut depths")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells traced at once")
    args = ap.parse_args(argv)
    if args.seq_shard and not args.tag:
        args.tag = "seq_shard"      # beside the unsharded records

    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multipod]
        failures = []

        def one(cell, mp):
            t0 = time.time()
            try:
                r = subprocess.run(_cell_cmd(args, cell.arch, cell.shape, mp),
                                   capture_output=True, text=True,
                                   timeout=args.timeout)
                rc, err = r.returncode, r.stderr
            except subprocess.TimeoutExpired:
                rc, err = -1, f"timed out after {args.timeout} s"
            return cell, mp, rc, err, time.time() - t0

        todo = []
        for cell in configs.cells():
            if args.shape and cell.shape != args.shape:
                continue
            for mp in meshes:
                if not cell.runnable:
                    run_cell(cell.arch, cell.shape, mp, args.out,
                             policy_kind=args.policy, fsdp=args.fsdp,
                             tag=args.tag, device=args.device,
                             layers=args.layers, mesh=args.mesh)
                    print(f"SKIP  {cell.arch} {cell.shape} "
                          f"{'mp' if mp else 'sp'}: {cell.skip_reason}")
                    continue
                todo.append((cell, mp))
        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            for cell, mp, rc, err, dt in pool.map(lambda c: one(*c), todo):
                status = "ok" if rc == 0 else "FAIL"
                print(f"{status:5s} {cell.arch:24s} {cell.shape:12s} "
                      f"{'mp' if mp else 'sp'} {dt:7.1f}s", flush=True)
                if rc != 0:
                    failures.append((cell.arch, cell.shape, mp))
                    print(err[-2000:])
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        return

    rec = run_cell(args.arch, args.shape, args.multipod, args.out,
                   policy_kind=args.policy, fsdp=args.fsdp,
                   grad_accum=args.grad_accum, tag=args.tag,
                   seq_shard=args.seq_shard, int8_gather=args.int8_gather,
                   device=args.device, layers=args.layers, mesh=args.mesh,
                   extrapolate=args.extrapolate, batch=args.batch,
                   seq=args.seq)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
