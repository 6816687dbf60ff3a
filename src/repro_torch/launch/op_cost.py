"""Per-rank cost of the ops one rank's program dispatches (the port's
counterpart of ``repro/launch/hlo_cost.py``).

The reference reads its roofline inputs from the partitioned HLO text of
a compiled program.  The port compiles no program: each rank runs its
own eager one, so this module counts the ops that program dispatches.
It is a ``TorchDispatchMode`` (:class:`CostMode`), entered inside
``FakeTensorMode`` (the dry run: shapes with no storage behind them) or
around a real run; the file is named for what it reads, dispatched ops,
not HLO.  :meth:`CostMode.result` returns the reference's keys
(``analyze``): ``flops``, ``bytes_accessed``, ``transcendentals``,
``collectives`` (kind -> ``ops`` / ``operand_bytes`` / ``result_bytes``),
``collective_operand_bytes`` and ``collective_ops``; ``n_ops`` takes the
place of ``n_computations``.

* FLOPs: ``2 * |result| * K`` for the contractions (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``addbmm``, ``_int_mm``, ``mv``, ``dot``;
  ``einsum`` and ``matmul`` reach the dispatcher as these), K the
  contracted size.  A convolution counts ``2 * |result| * prod(kernel[:
  -1])`` in the reference's kernel layout (spatial..., Cin, Cout), which
  is ``prod(weight.shape[1:])`` of PyTorch's ``[Cout, Cin / groups, kh,
  kw]``; its backward counts each of the two contractions it computes.
* Transcendentals: one per result element of ``exp``, ``tanh``, ``log``,
  ``rsqrt``, ``sqrt``, ``pow`` and ``sigmoid`` (the reference's
  ``exponential`` ... ``logistic``), of the ops that compute one of them
  an element (``exp2``, ``expm1``, ``log1p``, ``log2``, ``silu``,
  ``erf``) and of ``_softmax`` / ``_log_softmax`` / ``logsumexp`` (an
  exp an input element).  The port's gelu is the tanh form
  (``models.layers``), so ``erf`` appears only where a caller asks for
  it.
* Bytes: each materialising op counts its operands' bytes plus its
  results' bytes (a view operand its own extent, not its storage's).
  Ops that only make a view or touch metadata count nothing, the
  counterpart of the reference's ``_NONMEM``: views, ``empty`` (an
  allocation touches nothing), ``_local_scalar_dense`` (a host read of
  one element).  An op that overwrites its first operand without
  reading it (``copy_``, ``fill_``, ``zero_``) does not count it as a
  read, and an indexed write (``index_put_``, ``index_copy_``,
  ``scatter_``) writes only its values' bytes: an in-place write into a
  slice counts its window, the reference's dynamic-update-slice
  correction, which a view operand gives for free.  These are the bytes
  of an unfused eager program.  XLA's count excludes fusion internals,
  so the two are not the same quantity: an eager elementwise chain
  writes and reads every intermediate.
* Collectives: ops, operand bytes and result bytes by the reference's
  kinds (:data:`COLLECTIVE_KINDS`), from the c10d ops and their
  ``_c10d_functional`` forms (:data:`C10D_KINDS`).  A collective also
  counts its operand and result bytes in ``bytes_accessed``, as a
  top-level collective does in the reference's.  The ops a backend
  dispatches itself while a collective completes (gloo stages a
  reduce-scatter's output through a split and a copy; the fake group
  and NCCL dispatch none) are not the rank's program and count nothing.

Every tensor one rank sees is its own shard, so every total is a
per-rank quantity, as the reference's are per chip.  There is no
trip-count multiplier: an eager trace runs every layer and every
microbatch, so each is counted where it runs.

Memory.  The mode also keeps the bytes of the live storages: each new
storage an op returns is counted once, and subtracted through a weak
reference when it is freed (a ``weakref`` to the storage, whose Python
object lives as long as the storage does).  :meth:`CostMode.
hold` registers storages made before the mode (the arguments), and
``peak_bytes`` is the most ever live at once.
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute", "ragged-all-to-all")

# c10d op name -> (kind, operand argument, result argument): the indices
# of the arguments holding the operand and the result tensors
C10D_KINDS = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, None),
    "recv_": ("collective-permute", None, 0),
}
# _c10d_functional op name -> kind (operand: argument 0, result: the
# op's return value)
FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_CONTRACTIONS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm",
                 "mv", "dot", "vdot", "addmv"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "tanh", "tanh_", "log",
                   "log_", "log1p", "log2", "rsqrt", "rsqrt_", "sqrt",
                   "sqrt_", "pow", "pow_", "sigmoid", "sigmoid_", "silu",
                   "silu_", "erf", "erf_", "_softmax", "_log_softmax",
                   "logsumexp"}
# ops that touch no memory of note (the reference's _NONMEM): views are
# caught by their schema, these by name
_NONMEM = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "_local_scalar_dense", "_unsafe_view",
           "lift_fresh", "set_", "resize_", "sym_size", "sym_stride",
           "sym_numel", "sym_storage_offset", "is_same_size",
           "record_stream"}
# ops that overwrite their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
              "bernoulli_", "exponential_"}
# indexed writes: the written window is the values' size
_INDEXED = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
            "scatter_": 3}


def leaves(tree) -> list:
    """The tensors of an op's argument or result, or of a state: a
    tensor, lists and tuples of them (nested), a dict's values, a
    module's parameters."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if not isinstance(tree, (list, tuple)):
        return []
    out = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple, dict, torch.nn.Module)):
            out += leaves(a)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _numel(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def _contraction_flops(name: str, args, out) -> float:
    """``2 * |result| * K`` of a contraction."""
    a = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
        else args[0]
    k = a.shape[-1] if a.dim() else 1
    return 2.0 * out.numel() * k


_CONV = {"convolution", "_convolution", "conv2d", "conv1d",
         "cudnn_convolution", "mkldnn_convolution"}


def _conv_flops(name: str, args, out) -> float:
    """A convolution's (or its backward's) contractions: ``2 * |result|
    * K`` each, K = ``prod(weight.shape[1:])`` for the forward, the batch
    and output positions for the weight's gradient, the output channels
    of a group x the kernel window for the input's gradient."""
    if name in _CONV:
        return 2.0 * out.numel() * math.prod(args[1].shape[1:])
    # convolution_backward(grad_output, input, weight, ...) ->
    # (grad_input, grad_weight, grad_bias)
    gout, w = args[0], args[2]
    groups = args[8] if len(args) > 8 else 1
    gi, gw = out[0], out[1]
    flops = 0.0
    if gi is not None:
        flops += 2.0 * gi.numel() * (w.shape[0] // groups) * \
            math.prod(w.shape[2:])
    if gw is not None:
        flops += 2.0 * gw.numel() * gout.shape[0] * \
            math.prod(gout.shape[2:])
    return flops


# an op's class: what :meth:`CostMode._count` does with it
_SKIP, _COLL, _FCOLL, _MEM = range(4)


def _classify(func) -> tuple:
    """``(class, ...)``: ``(_SKIP, counted in n_ops, may allocate)``,
    ``(_COLL, c10d kind)``, ``(_FCOLL, kind)`` or ``(_MEM, name, flop
    kind, transcendental, overwrite, indexed values' argument)``."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns == "prim":            # a tensor's metadata read (``.device``)
        return (_SKIP, False, False)
    if ns == "c10d":
        kind = C10D_KINDS.get(name)
        return (_SKIP, True, True) if kind is None else (_COLL, kind)
    if ns == "_c10d_functional":
        kind = FUNCTIONAL_KINDS.get(name)
        return (_SKIP, True, True) if kind is None else (_FCOLL, kind)
    if func.is_view:            # a view allocates nothing
        return (_SKIP, True, False)
    if name in _NONMEM:
        return (_SKIP, True, True)
    flop = "mm" if name in _CONTRACTIONS else \
        "conv" if name in _CONV or name == "convolution_backward" else None
    return (_MEM, name, flop, name in _TRANSCENDENTAL, name in _OVERWRITE,
            _INDEXED.get(name))


class CostMode(TorchDispatchMode):
    """Counts every op dispatched inside it (module docstring) and keeps
    the live storage bytes; :meth:`result` gives the totals."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.n_ops = 0
        self.collectives = {k: {"ops": 0, "operand_bytes": 0,
                                "result_bytes": 0} for k in COLLECTIVE_KINDS}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._class: dict = {}

    # ---- live storages ----------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, weakref.ref(st, lambda _, k=key:
                                          self._free(k)))
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes

    def _free(self, key) -> None:
        n = self._live.pop(key, (0, None))[0]
        self.live_bytes -= n

    def hold(self, tree) -> int:
        """Track the storages of ``tree``'s tensors (made before the mode:
        the step's arguments; ``ParamTree`` modules read by their
        parameters) as live; returns the bytes of those not yet
        tracked."""
        before = self.live_bytes
        for t in leaves(tree):
            self._track(t)
        return self.live_bytes - before

    def storages(self, tree) -> set:
        """The keys of the tracked storages of ``tree``'s tensors."""
        return {id(t.untyped_storage()) for t in leaves(tree)}

    # ---- the count ---------------------------------------------------------
    def _collective(self, kind: str, operand, result) -> None:
        c = self.collectives[kind]
        ob, rb = _nbytes(operand), _nbytes(result)
        c["ops"] += 1
        c["operand_bytes"] += ob
        c["result_bytes"] += rb
        self.bytes_accessed += ob + rb

    def _count(self, func, args, kwargs, out) -> bool:
        """Count one op; returns whether its outputs may be new
        storages."""
        cls = self._class.get(func)
        if cls is None:
            cls = self._class[func] = _classify(func)
        what = cls[0]
        if what == _SKIP:
            self.n_ops += cls[1]
            return cls[2]
        self.n_ops += 1
        if what == _COLL:
            _, oi, ri = cls[1]
            self._collective(cls[1][0], () if oi is None else args[oi],
                             () if ri is None else args[ri])
            return True
        if what == _FCOLL:
            self._collective(cls[1], args[0], out)
            return True
        _, name, flop, trans, overwrite, indexed = cls
        if flop == "mm":
            self.flops += _contraction_flops(name, args, out)
        elif flop == "conv":
            self.flops += _conv_flops(name, args, out)
        elif trans:
            self.transcendentals += _numel(out)
        ops = leaves(args)
        if kwargs:
            ops += leaves(kwargs)
        if indexed is not None:
            # the indices and the values read, the values' window written
            self.bytes_accessed += _nbytes(ops) - _nbytes(args[0]) + \
                _nbytes(args[indexed])
            return True
        if overwrite:
            ops = ops[1:]
        self.bytes_accessed += _nbytes(ops) + _nbytes(out)
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cls = self._class.get(func)
        if cls is None:
            cls = self._class[func] = _classify(func)
        if cls[0] == _SKIP and not cls[1]:
            return out
        if cls[0] not in (_COLL, _FCOLL) and _in_collective(sys._getframe(1)):
            return out
        if self._count(func, args, kwargs, out):
            for t in leaves(out):
                self._track(t)
        return out

    def result(self) -> dict:
        """The reference's ``analyze`` keys (``n_ops`` for
        ``n_computations``)."""
        coll = {k: dict(v) for k, v in self.collectives.items()}
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "collectives": coll,
            "collective_operand_bytes": sum(v["operand_bytes"]
                                            for v in coll.values()),
            "collective_ops": sum(v["ops"] for v in coll.values()),
            "n_ops": self.n_ops,
        }


_BACKEND: dict = {}     # id(code) -> (code, called from torch.distributed)


def _in_collective(frame) -> bool:
    """Whether the innermost Python caller (past the compiler's wrappers)
    is ``torch.distributed``'s collective API: an op dispatched there is
    the backend's own work as a collective completes (gloo stages a
    reduce-scatter's output through a split and a copy), which another
    backend does not dispatch, not the rank's program."""
    while frame is not None:
        code = frame.f_code
        hit = _BACKEND.get(id(code))      # a code object hashes its body
        if hit is None or hit[0] is not code:
            name = code.co_filename
            hit = _BACKEND[id(code)] = (code, (
                "skip" if name.endswith(("eval_frame.py", "_compile.py",
                                         "c10d_logger.py"))
                or code.co_name == "__torch_dispatch__" else
                name.endswith("distributed_c10d.py")))
        if hit[1] != "skip":
            return hit[1]
        frame = frame.f_back
    return False


def analyze(fn, *args, **kwargs) -> dict:
    """:meth:`CostMode.result` of one call of ``fn(*args, **kwargs)``."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.result()


def count_bytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    """The bytes of the distinct storages behind ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        if t is None:
            continue
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total
