"""The data-parallel train step (``runtime.steps.make_train_step(...,
group=...)``) on 2 gloo ranks against the port's one-process step on the
whole batch, on the CPU; the ``compress`` hook against its emulation; a
sharded restore of a checkpoint onto a data mesh.

One module fixture spawns the 2 ranks once (``launch.mesh.spawn_ranks``,
a FileStore under a temporary directory); every rank runs each scenario
and saves what it got, and the tests hold that against the one-process
runs here.  Reduced starcoder2-3b and qwen2-moe-a2.7b, batch 4 x 32,
hindsight W8A8G8 on the fused backend (the kernels' plain versions on the
CPU), from a fresh state (the first-batch ranges) and from an initialized
one.

Bounds:
  * the quant state: bit for bit (the global program's statistics: ranks'
    extremes combine exactly, and each rank's cotangents and noise are the
    single-device step's on its rows);
  * parameters after one SGD step (``sgdm``, momentum 0, no clipping,
    which would hide a gradient off by a constant factor): within 1e-5 of
    each tensor's largest element plus 2**-7 of its largest update.  The
    model computes in bf16: a weight's or bias's gradient is a bf16
    contraction over the batch rows, which each rank rounds to bf16 over
    its half before the fp32 sum (the reference's GSPMD partials too);
    the fp32 norm parameters' updates agree to ~1e-6, the others' to
    ~4e-3 of their largest element (2**-8 is one bf16 rounding);
  * parameters after one AdamW step: every element within 2 lr.  AdamW's
    first update is sign-like, so an element whose gradient is rounding
    noise around 0 may move by 2 lr the other way (as the enc-dec train
    tests bound it);
  * the loss: within 1e-6 relative (the same sums in another order); the
    MoE step also to the reference's own bar, 1e-2.

This module imports no JAX: the rank processes import it.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_leaves, tree_map_with_path
from repro_torch.launch import mesh
from repro_torch.optim import adamw, sgdm
from repro_torch.optim.schedules import constant
from repro_torch.runtime import compress, steps

WORLD, B, S = 2, 4, 32
LR = {"adamw": 1e-3, "sgd": 1e-2, "lr0": 0.0}


def _run(group, arch, opt_name, nsteps, hook=None, batch=B, calls=None):
    cfg = configs.get_reduced(arch)
    pol = QuantPolicy.w8a8g8(backend="fused")
    opt = sgdm(momentum=0.0) if opt_name == "sgd" else adamw()
    st = steps.init_train_state(cfg, opt, pol, seed=0, device="cpu")
    # SGD unclipped: its update is lr times the reduced gradient itself
    ts = steps.make_train_step(cfg, pol, opt, constant(LR[opt_name]),
                               clip_norm=None if opt_name == "sgd" else 1.0,
                               compress=hook, group=group)
    stream = data.for_arch(cfg, seq_len=S, global_batch=batch, seed=0)
    losses, collectives = [], []
    for i in range(nsteps):
        st, met = ts(st, stream.batch(i))
        losses.append(float(met["loss"]))
        collectives.append(None if calls is None else len(calls))
    return {"loss": losses, "quant": st["quant"], "collectives": collectives,
            "params": {k: v.detach().clone()
                       for k, v in st["params"].named_parameters()}}


class _Recording(compress.Compressor):
    """The compressor, keeping what it was given and what it returned."""

    def __call__(self, grads, stats):
        self.seen = {k: g.clone() for k, g in grads.items()}
        self.state_in = None if self.state is None else dict(self.state)
        out = super().__call__(grads, stats)
        self.out = {k: g.clone() for k, g in out[0].items()}
        return out


SCENARIOS = {
    "dense_adamw": ("starcoder2-3b", "adamw", 1),
    "dense_sgd": ("starcoder2-3b", "sgd", 1),
    "dense_lr0": ("starcoder2-3b", "lr0", 2),
    "moe_adamw": ("qwen2-moe-a2.7b", "adamw", 1),
    "moe_lr0": ("qwen2-moe-a2.7b", "lr0", 2),
}


def _ranks(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch import checkpoint
    from repro_torch.runtime import sharding
    group = dist.group.WORLD
    calls, real = [], sharding.dp_minmax

    def counted(mn, mx):      # the per-site (min, max) all_reduce
        calls.append(1)
        return real(mn, mx)

    sharding.dp_minmax = counted
    res = {}
    for name, args in SCENARIOS.items():
        calls.clear()
        res[name] = _run(group, *args, calls=calls)
    sharding.dp_minmax = real
    res["replicated"] = _run(group, "starcoder2-3b", "adamw", 1, batch=3)
    hook = _Recording(group, seed=5)
    res["compress"] = _run(group, "starcoder2-3b", "adamw", 1, hook)
    res["compress"].update(seen=hook.seen, out=hook.out, seed=hook.seed,
                           cstate=hook.state)
    # a checkpoint restored onto a data mesh of the two ranks
    state = steps.init_train_state(configs.get_reduced("starcoder2-3b"),
                                   adamw(), seed=0, device="cpu")
    ck = f"{out_dir}/ckpt"
    if rank == 0:
        checkpoint.save(ck, 0, state)
    dist.barrier()
    dmesh = mesh.make_mesh((world,), ("data",), "cpu")
    specs = sharding.train_state_pspecs(state, dmesh)
    got = checkpoint.restore(ck, 0, state,
                             shardings=sharding.named(specs, dmesh))
    res["ckpt"] = {
        "specs": {k: tuple(v) for k, v in specs["params"].items()},
        "full": {k: t.full_tensor()
                 for k, t in got["params"].named_parameters()},
        "local": {k: tuple(t.to_local().shape)
                  for k, t in got["params"].named_parameters()},
        "placements": {k: str(t.placements)
                       for k, t in got["params"].named_parameters()},
        "want": {k: v.detach().clone()
                 for k, v in state["params"].named_parameters()},
        "step": got["step"]}
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    mesh.spawn_ranks(_ranks, WORLD, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _quant_equal(a, b):
    bad = []
    tree_map_with_path(
        lambda path, x, y: None if torch.equal(x, y) else bad.append(path),
        a, b)
    assert not bad, bad[:5]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dp_quant_state_bit_equal(dp, name):
    """Both ranks hold the single-device step's quant state bit for bit
    (from a fresh state, and for the lr-0 runs after a second step from
    the initialized one), and the same loss within 1e-6."""
    one = _run(None, *SCENARIOS[name])
    for got in dp:
        _quant_equal(got[name]["quant"], one["quant"])
        for a, b in zip(got[name]["loss"], one["loss"]):
            assert abs(a - b) <= 1e-6 * abs(b), (a, b)
    assert sum(int(leaf[2] > 0.5) for leaf in tree_leaves(one["quant"])) > 0


@pytest.mark.parametrize("name", ["dense_lr0", "moe_lr0"])
def test_dp_initialized_sites_wait_on_no_collective(dp, name):
    """The per-site (min, max) all_reduce runs only where the range reads
    the tensor: on the first batch every site takes it, and from the
    initialized state (the second step) no site does; the statistics
    then merge once, at the end of the step, and the quant state stays
    the one-process step's (``test_dp_quant_state_bit_equal``)."""
    for got in dp:
        first, second = got[name]["collectives"]
        assert first > 0
        assert second == first


def _params_close(got, one, init, lr, sign_like):
    for k, want in one.items():
        d = (got[k] - want).abs()
        if sign_like:
            assert float(d.max()) <= 2 * lr * 1.001, (k, float(d.max()))
            continue
        bound = 1e-5 * want.abs().max() + 2 ** -7 * (want - init[k]).abs().max()
        assert float(d.max()) <= float(bound), (k, float(d.max()),
                                                float(bound))


@pytest.mark.parametrize("name", ["dense_sgd", "dense_adamw", "moe_adamw"])
def test_dp_params_after_one_step(dp, name):
    arch, opt, n = SCENARIOS[name]
    one = _run(None, arch, opt, n)
    from repro_torch.models import model
    init = dict(model.init_params(configs.get_reduced(arch), seed=0,
                                  device="cpu").named_parameters())
    for got in dp:
        _params_close(got[name]["params"], one["params"], init, LR[opt],
                      sign_like=opt == "adamw")
    # the ranks stay replicas of each other bit for bit
    for k, v in dp[0][name]["params"].items():
        assert torch.equal(v, dp[1][name]["params"][k]), k


def test_moe_dp_loss_to_reference_bar(dp):
    """The reference's own bar for its 8-device SPMD step against one
    device (qwen2-moe-a2.7b): the loss within 1e-2."""
    one = _run(None, "qwen2-moe-a2.7b", "adamw", 1)
    assert abs(dp[0]["moe_adamw"]["loss"][0] - one["loss"][0]) < 1e-2


def test_dp_compress_matches_emulation(dp):
    """The step's ``compress`` hook on each rank's per-replica gradient
    (N times its share) against a one-process emulation: per-rank
    quantize (first call: scale from the pmax of |g| over the ranks; the
    port's own leaf noise), int32 sum, ``* scale / n``; bit for bit.  The
    quant state is the plain DP step's (compression touches the
    gradients only)."""
    seen = [r["compress"]["seen"] for r in dp]
    fresh = compress.init_compress_state(seen[0])
    want, wstats = compress.emulate_all_reduce_tree(
        seen, fresh, dp[0]["compress"]["seed"])
    for k in want:
        for r in dp:
            assert torch.equal(r["compress"]["out"][k], want[k]), k
        # the hook's range state: the first update takes the statistics
        assert torch.equal(dp[0]["compress"]["cstate"][k], wstats[k]), k
    _quant_equal(dp[0]["compress"]["quant"], dp[0]["dense_adamw"]["quant"])


def test_dp_step_replicates_an_indivisible_batch(dp):
    """A batch the ranks do not divide (3 rows on 2 ranks) is replicated,
    as ``batch_pspecs`` rules: every rank runs the one-process step on the
    whole batch, bit for bit (no reduction runs)."""
    one = _run(None, "starcoder2-3b", "adamw", 1, batch=3)
    for got in dp:
        _quant_equal(got["replicated"]["quant"], one["quant"])
        assert got["replicated"]["loss"] == one["loss"]
        for k, v in one["params"].items():
            assert torch.equal(got["replicated"]["params"][k], v), k


def test_sharded_restore_onto_data_mesh(dp):
    """``checkpoint.restore(..., shardings=named(specs, mesh))`` places
    each leaf with ``distribute_tensor`` on the 2-rank data mesh: the
    rule's ``data`` dims sharded (each rank holds half), the rest
    replicated, and the whole tensors equal what was saved."""
    for r, got in enumerate(dp):
        ck = got["ckpt"]
        assert ck["step"] == 0
        sharded = 0
        for k, want in ck["want"].items():
            assert torch.equal(ck["full"][k], want), k
            spec = ck["specs"][k]
            dims = [i for i, ax in enumerate(spec)
                    if ax == "data" or (isinstance(ax, tuple) and "data" in ax)]
            if dims:
                d = dims[0]
                assert ck["local"][k][d] * WORLD == want.shape[d], k
                assert "Shard" in ck["placements"][k]
                sharded += 1
            else:
                assert ck["local"][k] == tuple(want.shape), k
        assert sharded > 0


def test_moe_dp_refuses_a_partial_group(monkeypatch):
    """A data-parallel rank's tokens must fill whole groups of
    ``group_size``.  With groups of 128, the global batch (4 x 32) fills
    one and a rank's half does not: the layer raises rather than group
    the rank's 64 tokens alone, which would give another group size and
    capacity than the global program's.  One process takes the whole
    batch."""
    from repro_torch.models import moe
    from repro_torch.runtime import sharding
    cfg = configs.get_reduced("qwen2-moe-a2.7b")
    spec = dataclasses.replace(cfg.moe, group_size=B * S)
    pol = QuantPolicy.w8a8g8(backend="fused")
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg.d_model, spec)
    sites = moe.init_moe_sites(spec)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    y, _, _ = moe.apply_moe(params, sites, x, spec, policy=pol, seed=0,
                            step=0)
    assert y.shape == x.shape
    monkeypatch.setattr(sharding, "_DP", (None, 0, WORLD))
    with pytest.raises(ValueError, match="whole groups of 128"):
        moe.apply_moe(params, sites, x[:B // WORLD], spec, policy=pol,
                      seed=0, step=0)


@pytest.mark.parametrize("espec,xshape,wshape,batch_dim,calls", [
    ("btd,df->btf", (4, 32, 8), (8, 16), 0, 4),      # 32 rows an index
    ("egcd,edf->egcf", (2, 3, 8, 8), (2, 8, 16), 1, 3),   # 2 x 8 rows
    ("bd,dc->bc", (8, 8), (8, 5), 0, 1),             # a classifier's 1 row
])
def test_dx_split_gate(monkeypatch, espec, xshape, wshape, batch_dim,
                       calls):
    """The backward's ``dx`` product runs one batch index at a time
    (batch-invariant on the card) where an index holds
    ``SPLIT_MIN_ROWS`` rows or more, and whole where it holds a GEMV's
    rows; either way it is the whole-batch product's value."""
    from repro_torch.core import backend
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(xshape, generator=gen, requires_grad=True)
    w = torch.randn(wshape, generator=gen)
    x_img = torch.zeros(xshape, dtype=torch.uint8)
    w_img = torch.zeros(wshape, dtype=torch.int8)
    lhs, y = espec.split("->")
    xs, ws = lhs.split(",")
    dx_spec, seen = f"{y},{ws}->{xs}", []
    real = torch.einsum

    def counted(spec, *ops):
        seen.append(spec)
        return real(spec, *ops)

    out = backend._QMatmulInt.apply(x, w, x_img, w_img, torch.tensor(0.0),
                                    torch.tensor(1.0), espec, False,
                                    batch_dim, None)
    g = torch.randn(out.shape, generator=gen)
    monkeypatch.setattr(torch, "einsum", counted)
    (dx,) = torch.autograd.grad(out, x, g)
    monkeypatch.setattr(torch, "einsum", real)
    assert seen.count(dx_spec) == calls
    torch.testing.assert_close(dx, torch.einsum(dx_spec, g, w), rtol=1e-6,
                               atol=1e-6)
