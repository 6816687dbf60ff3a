"""Port vs reference: checkpointing (``repro_torch.checkpoint``) and the
drivers' ``--ckpt-dir`` / ``--resume`` flags, on the CPU.

The first part holds the port to the reference's own
``tests/test_checkpoint.py`` cases (bit-exact resume, the persisted quant
state, ``keep_last``, atomicity, the shape-mismatch and missing-leaf
errors).  The rest reads checkpoints across the packages: the format is
the reference's (``step_<step:010d>/arrays.npz`` + ``manifest.json``), a
reference train state loads through ``load_arrays`` / ``nest`` and
``convert.train_state_from_jax``, and a checkpoint without the telemetry
slots resumes a telemetry run.

Tolerance everywhere: bit-equal.  A resumed run replays the same ops on
the same values (the stochastic-rounding noise is keyed by the step), so
it matches the uninterrupted run exactly on one device.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import checkpoint, configs, convert, data
from repro_torch import optim as topt
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.runtime import steps

ARCH = "starcoder2-3b"


def _setup(policy=None):
    cfg = configs.get_reduced(ARCH)
    policy = policy or QuantPolicy.w8a8g8()
    opt = topt.adamw(weight_decay=0.0)
    state = steps.init_train_state(cfg, opt, policy, device="cpu")
    stream = data.for_arch(cfg, seq_len=32, global_batch=4)
    ts = steps.make_train_step(cfg, policy, opt, topt.constant(1e-3))
    return cfg, opt, state, stream, ts


def _assert_equal_states(a, b):
    la, lb = list(_flatten(a)), list(_flatten(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def test_bit_exact_resume(tmp_path):
    """6 steps straight vs 3 + save + restore into a fresh template + 3:
    identical states, quant ranges included."""
    cfg, opt, state, stream, ts = _setup()
    for i in range(6):
        state, _ = ts(state, stream.batch(i))
    _, _, sB, _, _ = _setup()
    for i in range(3):
        sB, _ = ts(sB, stream.batch(i))
    checkpoint.save(str(tmp_path), 3, sB)
    sB2 = checkpoint.restore(str(tmp_path), 3, _setup()[2])
    _assert_equal_states(sB, sB2)
    assert all(p.requires_grad for p in sB2["params"].parameters())
    for i in range(3, 6):
        sB2, _ = ts(sB2, stream.batch(i))
    _assert_equal_states(state, sB2)


def test_quant_state_is_persisted(tmp_path):
    cfg, opt, state, stream, ts = _setup()
    for i in range(3):
        state, _ = ts(state, stream.batch(i))
    checkpoint.save(str(tmp_path), 3, state)
    restored = checkpoint.restore(str(tmp_path), 3, state)
    head = restored["quant"]["head"]["grad"].numpy()
    assert head[2] == 1.0 and head[0] != 0.0
    assert restored["step"] == 3 and isinstance(restored["step"], int)


def test_keep_last_prunes(tmp_path):
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), s, {"x": torch.ones(2) * s},
                        keep_last=2)
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]
    assert checkpoint.latest_step(str(tmp_path)) == 5


def test_atomicity_no_partial_dirs(tmp_path, monkeypatch):
    """No ``.tmp_`` directory is left, after a write and after a writer
    that fails midway; the failed step never becomes visible."""
    checkpoint.save(str(tmp_path), 7, {"x": torch.arange(4)})

    def broken(*_a, **_k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError):
        checkpoint.save(str(tmp_path), 8, {"x": torch.arange(4)})
    assert [e for e in os.listdir(tmp_path) if e.startswith(".tmp_")] == []
    assert checkpoint.all_steps(str(tmp_path)) == [7]


def test_restore_shape_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 1, {"x": torch.zeros(5)})


def test_restore_missing_leaf_raises(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), 1, {"y": torch.zeros(4)})


# ---------------------------------------------------------------------------
# The format across the packages.
# ---------------------------------------------------------------------------
def test_format_is_the_references(tmp_path):
    """The port writes what the reference reads, and reads what it
    writes: directory name, manifest and arrays; the template's dtype and
    Python numbers come back."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32)}, "n": 5}
    path = checkpoint.save(str(tmp_path), 12, tree)
    assert os.path.basename(path) == "step_0000000012"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 12
    assert [e["path"] for e in man["leaves"]] == ["a", "b/c", "n"]
    ref = jcheckpoint.restore(str(tmp_path), 12, {
        "a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros((2,), jnp.int32)},
        "n": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(ref["a"]), tree["a"].numpy())
    assert jcheckpoint.latest_step(str(tmp_path)) == 12
    jcheckpoint.save(str(tmp_path), 13, ref)
    back = checkpoint.restore(str(tmp_path), 13, tree)
    _assert_equal_states(tree, back)


def test_reference_train_state_loads_bit_equal(tmp_path):
    """A reference train state (telemetry width) written by
    ``repro.checkpoint.save`` becomes the port's through ``load_arrays``,
    ``nest`` and ``convert.train_state_from_jax``: parameters, quant tree
    and step bit-equal to the reference's arrays."""
    cfg_j = jconfigs.get_reduced(ARCH)
    pol = JPolicy.w8a8g8().with_telemetry()
    state = jax.jit(lambda k: jsteps.init_train_state(
        k, cfg_j, jadamw(), pol))(jax.random.PRNGKey(3))
    state["step"] = jnp.int32(4)
    jcheckpoint.save(str(tmp_path), 4, state)
    arrays = checkpoint.load_arrays(str(tmp_path), 4)
    tree = checkpoint.nest(arrays)
    cfg_t = configs.get_reduced(ARCH)
    st = convert.train_state_from_jax(tree, cfg_t, topt.adamw(), "cpu")
    assert st["step"] == 4
    got = convert.to_jax_layout(st["quant"], cfg_t)
    got_p = convert.params_to_jax(st["params"], cfg_t)
    for ref_tree, port_tree in ((state["quant"], got),
                                (state["params"], got_p)):
        ref_l = jax.tree_util.tree_leaves_with_path(ref_tree)
        port_l = jax.tree_util.tree_leaves_with_path(port_tree)
        assert [p for p, _ in ref_l] == [p for p, _ in port_l]
        for (path, a), (_, b) in zip(ref_l, port_l):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b,
                                          jax.tree_util.keystr(path))
    assert got["head"]["act"].shape == (10,)


# ---------------------------------------------------------------------------
# The drivers.
# ---------------------------------------------------------------------------
ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--steps", "3"]


def _preempt_at(monkeypatch, step: int):
    """The driver's stream sends this process SIGTERM while it fetches
    batch ``step``: the run checkpoints after that step and stops (the
    reference's preemption path), with the LR schedule of the full run."""
    import signal
    real = data.for_arch

    class Preempted:
        def __init__(self, stream):
            self.stream = stream

        def batch(self, i):
            if i == step:
                os.kill(os.getpid(), signal.SIGTERM)
            return self.stream.batch(i)
    monkeypatch.setattr(train.data, "for_arch",
                        lambda *a, **k: Preempted(real(*a, **k)))


def test_train_driver_resume_is_bit_exact(tmp_path, monkeypatch):
    """``launch.train``: 3 steps straight vs a run with ``--ckpt-dir
    --ckpt-every 1 --telemetry`` preempted after 2 steps and ``--resume``d
    to 3."""
    ck = str(tmp_path / "ck")
    straight = train.main(ARGS + ["--telemetry", "--telemetry-dir",
                                  str(tmp_path)])
    with monkeypatch.context() as m:
        _preempt_at(m, 1)
        first = train.main(ARGS + ["--ckpt-dir", ck, "--ckpt-every", "1",
                                   "--telemetry"])
    assert first.state["step"] == 2
    assert checkpoint.all_steps(ck) == [1, 2] and len(first.ckpt_ms) == 2
    restored = checkpoint.restore(ck, 2, first.state)
    _assert_equal_states(first.state, restored)
    resumed = train.main(ARGS + ["--ckpt-dir", ck, "--resume",
                                 "--telemetry"])
    assert resumed.start == 2 and resumed.losses == straight.losses[2:]
    _assert_equal_states(straight.state, resumed.state)
    lines = [json.loads(ln) for ln in open(first.telemetry_path)]
    assert [ln["step"] for ln in lines] == [0, 1, 2]
    assert all("checkpoint" in ln["perf"]["phases_ms"] for ln in lines)


def test_width3_checkpoint_resumes_a_telemetry_run(tmp_path, monkeypatch,
                                                   capsys):
    """A checkpoint without the telemetry slots: the ranges carry over
    into width-10 leaves, the counters start at zero, and the resumed
    run's ranges equal those of a straight run without telemetry (the
    counters never feed back without the guard)."""
    ck = str(tmp_path / "ck")
    straight = train.main(ARGS)
    with monkeypatch.context() as m:
        _preempt_at(m, 1)
        train.main(ARGS + ["--ckpt-dir", ck])
    resumed = train.main(ARGS + ["--ckpt-dir", ck, "--resume",
                                 "--telemetry"])
    assert "migrated width-3 quant state" in capsys.readouterr().out
    assert resumed.start == 2 and resumed.losses == straight.losses[2:]
    from repro_torch.core.state import tree_leaves
    for a, b in zip(tree_leaves(straight.state["quant"]),
                    tree_leaves(resumed.state["quant"])):
        assert b.shape == (10,) and torch.equal(a, b[:3])


def test_serve_from_checkpoint_equals_in_memory(tmp_path, capsys):
    """``launch.serve --ckpt-dir``: the prefill logits of the trained state
    served from its checkpoint equal those served from memory; a failed
    restore serves from init."""
    ck = str(tmp_path / "ck")
    run = train.main(ARGS + ["--ckpt-dir", ck])
    cfg = configs.get_reduced(ARCH)
    sargs = ["--reduced", "--device", "cpu", "--batch", "2",
             "--prompt-len", "16", "--gen", "2"]
    served = serve.main(sargs + ["--ckpt-dir", ck])
    assert "restored step 3" in capsys.readouterr().out
    policy = QuantPolicy.w8a8g8(backend="fused")
    mem = serve.generate(run.state["params"], run.state["quant"],
                         served.prompt, cfg, policy, 2)
    assert torch.equal(served.prefill_logits, mem.prefill_logits)
    assert torch.equal(served.tokens, mem.tokens)
    fresh = serve.main(sargs + ["--ckpt-dir", str(tmp_path / "none")])
    assert "restore failed" in capsys.readouterr().out
    init = model.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(fresh.params.embed, init.embed)
