"""The dry run (``launch.dryrun``) on the CPU: fake tensors under a fake
process group.

(a) ``count_params`` / ``moe_inactive_params`` of the ten configs at full
    size, on fake parameters, equal the reference's on ``jax.eval_shape``
    trees (the reference's module runs in a subprocess: it sets
    ``XLA_FLAGS`` and a JAX config flag when imported).
(b) The fake trace against a real run: reduced starcoder2-3b (2 layers)
    stored (``--fsdp 2d``) on a ``(2, 2)`` mesh.  Four gloo ranks take a
    first step, then a second under ``CostMode``; rank 0's counts (FLOPs,
    bytes, transcendentals, ops, collective ops and bytes by kind) equal
    the fake trace's exactly, as do the host reads the trace answered
    (the real second step reads the same flags) and the arguments' bytes,
    which are the real stored state's and rank 0's batch rows' bytes.
    :func:`launch.dryrun.extrapolated_trace` from 2 and 3 layers equals
    a 4-layer trace exactly: counts, host reads and memory.
(c) ``run_cell`` on the production 16 x 16 mesh (256 fake ranks) writes
    the reference's keys with ``status == "ok"`` for full-width
    recurrentgemma-9b cut to 2 layers (two RG-LRU blocks), ``train_4k``
    (one microbatch of 16 rows: one a data rank) and ``decode_32k``; a
    refused cell
    (``long_500k`` on full attention) is written ``skipped`` with its
    reason; the train cell traced again with ``seq_shard`` (the residual
    stream the rank's rows of the sequence) is ``ok``, runs more
    reduce-scatters (the row-parallel exits) and holds fewer bytes a
    rank; no process group is left behind.
(d) ``--all --seq-shard --shape train_4k`` forwards the flag to every
    cell's subprocess under the ``seq_shard`` tag, that shape only.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun, mesh, op_cost
from repro_torch.models import model

ARCH = "starcoder2-3b"
SERVE_ARCH = "recurrentgemma-9b"      # (c): two "rec" blocks at 2 layers
SHAPE = configs.ShapeSpec("train_4k", 32, 8, "train")
MESH = (1, 2, 2)
POLICY = dryrun._policy("hindsight", False)

_REF = """
import json, jax
from repro import configs
from repro.launch import dryrun
from repro.models import model
out = {}
for a in configs.names():
    cfg = configs.get(a)
    sds = jax.eval_shape(lambda k: model.init_params(k, cfg),
                         jax.random.PRNGKey(0))
    out[a] = [dryrun.count_params(sds), dryrun.moe_inactive_params(cfg, sds)]
print(json.dumps(out))
"""


def test_param_counts_equal_the_references():
    from torch._subclasses.fake_tensor import FakeTensorMode
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(ref) == configs.names()
    with FakeTensorMode():
        for a in configs.names():
            cfg = configs.get(a)
            p = model.init_params(cfg, device="cpu")
            assert [dryrun.count_params(p),
                    dryrun.moe_inactive_params(cfg, p)] == ref[a], a


def _real_rank(rank, world, out_dir):
    torch.set_num_threads(1)
    g = mesh.mesh_groups(MESH[1], MESH[2], MESH[0])
    cfg = configs.get_reduced(ARCH)
    fn, args, _ = dryrun.build_cell(cfg, SHAPE, g, POLICY, device="cpu")
    state, _ = fn(*args)                        # the first step
    batch = args[1]
    rows = dryrun.batch_rows(SHAPE.global_batch, g)
    mode = dryrun.SteadyState()         # records the real step's reads
    cost, mem = dryrun.trace_step(fn, (state, batch), state, batch, rows,
                                  SHAPE.global_batch, mode)
    out = {"cost": cost, "memory": mem, "reads": mode.reads,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in op_cost.leaves(state)),
           "batch_bytes": sum(t[rows[0]:rows[0] + rows[1]].numel()
                              * t.element_size() for t in batch.values())}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    mesh.spawn_ranks(_real_rank, 4, d / "store", args=(str(d),))
    return torch.load(d / "rank0.pt", weights_only=False)


@pytest.fixture(scope="module")
def fake():
    cfg = configs.get_reduced(ARCH)
    return {k: dryrun.trace_cell(dryrun.cut_depth(cfg, k), SHAPE, MESH,
                                 POLICY, device="cpu") for k in (2, 4)}


def test_fake_trace_counts_equal_a_real_second_step(real, fake):
    got = fake[2]
    assert got["cost"] == real["cost"]
    assert got["cost"]["flops"] > 0 and got["cost"]["collective_ops"] > 0
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        assert got["cost"]["collectives"][kind]["ops"] > 0, kind
    # the flags the trace assumed are the ones a second step reads
    assert got["reads"] == real["reads"] and got["reads"]
    assert all(r["answer"] for r in got["reads"].values())
    mem, want = got["memory"], real["memory"]
    assert mem["argument_size_in_bytes"] == want["argument_size_in_bytes"] \
        == real["state_bytes"] + real["batch_bytes"]
    assert mem["stored_state_bytes"] == want["stored_state_bytes"]


def test_extrapolated_trace_equals_a_deeper_trace(fake):
    """4 layers from traces of 2 and 3: every count, the host reads and
    every memory figure equal the 4-layer trace's."""
    cfg = dryrun.cut_depth(configs.get_reduced(ARCH), 4)
    ex, traced = dryrun.extrapolated_trace(cfg, SHAPE, MESH, POLICY,
                                           device="cpu")
    assert traced == [2, 3]
    for k in ("cost", "reads", "memory"):
        assert ex[k] == fake[4][k], k


_KEYS = {"arch", "shape", "mesh", "policy", "fsdp", "tag", "seq_shard",
         "grad_accum_override", "status", "memory", "cost", "collectives",
         "model"}


def test_run_cell_on_the_production_mesh(tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = str(tmp_path)
    with FakeTensorMode():
        n_params = dryrun.count_params(model.init_params(
            dryrun.cut_depth(configs.get(SERVE_ARCH), 2), device="cpu"))
    recs = [dryrun.run_cell(SERVE_ARCH, "train_4k", False, out,
                            device="cpu", layers=2, grad_accum=1, batch=16),
            dryrun.run_cell(SERVE_ARCH, "decode_32k", False, out,
                            device="cpu", layers=2)]
    assert not dist.is_initialized()
    for rec in recs:
        assert _KEYS <= set(rec) and rec["status"] == "ok", rec
        assert rec["mesh"] == "16x16" and rec["world"] == 256
        assert rec["coords"] == {"data": 0, "model": 0}
        m = rec["memory"]
        assert set(m) == {"argument_size_in_bytes", "stored_state_bytes",
                          "output_size_in_bytes", "temp_size_in_bytes",
                          "alias_size_in_bytes", "per_device_bytes_est"}
        assert 0 < m["stored_state_bytes"] <= m["argument_size_in_bytes"]
        assert m["per_device_bytes_est"] == m["argument_size_in_bytes"] + \
            m["temp_size_in_bytes"] + m["output_size_in_bytes"] - \
            m["alias_size_in_bytes"]
        assert rec["cost"]["flops"] > 0
        assert set(rec["collectives"]) >= {"all-reduce", "all-gather",
                                           "total_operand_bytes",
                                           "total_ops"}
        assert rec["model"]["n_params"] == n_params
        name = f"{SERVE_ARCH}__{rec['shape']}__16_16.json"
        assert json.load(open(os.path.join(out, name)))["status"] == "ok"
    train = recs[0]
    assert train["collectives"]["reduce-scatter"]["ops"] > 0
    assert train["memory"]["alias_size_in_bytes"] >= \
        train["memory"]["stored_state_bytes"]
    assert train["model"]["tokens_per_step"] == 16 * 4096
    skipped = dryrun.run_cell("command-r-35b", "long_500k", False, out,
                              device="cpu")
    assert skipped["status"] == "skipped" and "full attention" in \
        skipped["reason"]
    sp = dryrun.run_cell(SERVE_ARCH, "train_4k", False, out, device="cpu",
                         layers=2, grad_accum=1, batch=16, seq_shard=True,
                         tag="seq_shard")
    assert sp["status"] == "ok" and sp["seq_shard"] is True
    assert sp["collectives"]["reduce-scatter"]["ops"] > \
        train["collectives"]["reduce-scatter"]["ops"]
    assert sp["memory"]["per_device_bytes_est"] < \
        train["memory"]["per_device_bytes_est"]
    assert os.path.exists(os.path.join(
        out, f"{SERVE_ARCH}__train_4k__16_16__seq_shard.json"))
    assert not dist.is_initialized()


def test_all_forwards_seq_shard_under_its_own_tag(monkeypatch, tmp_path):
    """``--all --seq-shard --shape train_4k`` starts one subprocess a
    train cell and mesh, each with ``--seq-shard`` and the ``seq_shard``
    tag (its records beside the unsharded ones), and no other shape."""
    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(dryrun.subprocess, "run", run)
    dryrun.main(["--all", "--both-meshes", "--seq-shard", "--shape",
                 "train_4k", "--out", str(tmp_path), "--device", "cpu"])
    want = [c for c in configs.cells() if c.shape == "train_4k"]
    assert len(cmds) == 2 * sum(c.runnable for c in want) > 0
    for cmd in cmds:
        assert cmd[cmd.index("--shape") + 1] == "train_4k"
        assert "--seq-shard" in cmd
        assert cmd[cmd.index("--tag") + 1] == "seq_shard"
    assert sum("--multipod" in c for c in cmds) == len(cmds) // 2
