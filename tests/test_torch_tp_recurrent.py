"""The ``model`` mesh axis for the recurrent kinds: reduced
recurrentgemma-9b (``rec``, ``rec``, ``local``: the RG-LRU
channel-parallel, the local attention on the ``g`` layout) and rwkv6-7b
(``rwkv``: the time mix head-parallel, the channel mix a Megatron pair
on ``d_ff``) on gloo ranks against the port's one-process program, on
the CPU.

One module fixture spawns 4 ranks once (``launch.mesh.spawn_ranks``, a
FileStore under a temporary directory): they run each arch's train step
on a ``(data 2, model 2)`` mesh (``launch.mesh.mesh_groups``), then, as
two ``(1, 2)`` meshes of ranks {0, 1} and {2, 3}, each arch's train step,
its prefill and greedy decode, and ``gather_params`` of their shards.
Each rank saves what it got; the tests hold that against one process
here.  Hindsight W8A8G8 on the fused backend (the kernels' plain
versions on the CPU), from a fresh state (the first-batch ranges), batch
4 x 32.

Bounds (those of ``tests/test_torch_tp.py``):
  * activation-site quant state: bit for bit (the int8 products are
    exact integers, a row-parallel product sums int32 partials before
    its one fp32 rounding, the conv, the gates, the scan and the WKV run
    per channel or per head, and the ranges combine by min/max);
  * gradient-site quant state: within 1e-5 of each leaf's largest
    element (the backward sums a column-parallel ``dx`` over the model
    group in fp32, in another order than one product);
  * the loss: within 1e-5 relative;
  * parameter gradients (clipped): within 2**-7 relative L2 of each
    tensor;
  * serve: the prefill statistics bit for bit, each rank's ``h`` /
    ``conv`` / ``state`` (and a local block's KV heads) the one-process
    cache's slice, ``x_time`` / ``x_chan`` whole, the logits within 1e-5
    relative L2, the greedy tokens identical.
"""
import pytest
import torch

from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map_with_path
from repro_torch.launch import mesh
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding, steps

B, S, LR, GEN = 4, 32, 1e-3, 3
ARCHS = ("recurrentgemma-9b", "rwkv6-7b")
POLICY = QuantPolicy.w8a8g8(backend="fused")


class _Spy:
    """An optimizer that keeps the (reduced, clipped) gradients it is
    given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params, lr)


def _train(arch, groups=None):
    """One AdamW step from seed 0; returns the loss, the quant state, the
    gradients and the parameters after the step (a rank's shards under
    ``groups``)."""
    cfg = configs.get_reduced(arch)
    opt = _Spy(adamw())
    st = steps.init_train_state(cfg, opt, POLICY, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        params = sharding.shard_params(st["params"], groups.coords,
                                       groups.sizes)
        st = steps.train_state(params, st["quant"], opt)
        kw = dict(group=groups.data, model_group=groups.model)
    ts = steps.make_train_step(cfg, POLICY, opt, constant(LR), **kw)
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "grads": opt.grads, "params": st["params"]}


def _serve(arch, model_group=None, coords=None, sizes=None):
    """Prefill (statistics returned) and GEN greedy decode steps; the
    caches after the prefill."""
    cfg = configs.get_reduced(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    if model_group is not None:
        params = sharding.shard_params(params, coords, sizes)
    quant = model.init_quant_state(cfg, POLICY, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=1).batch(0)
    prefill = steps.make_prefill_step(cfg, POLICY, model_group=model_group,
                                      return_stats=True)
    decode = steps.make_decode_step(cfg, POLICY, model_group=model_group)
    logits, caches, stats = prefill(params, quant,
                                    {"tokens": batch["tokens"]})
    out = {"logits": [logits], "stats": stats, "tokens": [],
           "cache": tree_map_with_path(lambda p, t: t.clone(),
                                       caches["decoder"])}
    for i in range(GEN):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        pos = torch.full((B,), S + i, dtype=torch.long)
        logits, caches = decode(params, quant, {"token": tok[:, None],
                                                "pos": pos}, caches)
        out["logits"].append(logits)
    return out


def _ranks(rank, world, out_dir):
    import torch.distributed as dist
    res = {f"{a}/mesh": _train(a, mesh.mesh_groups(2, 2)) for a in ARCHS}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair, m = pairs[rank // 2], rank % 2
    groups = mesh.MeshGroups(None, pair, {"data": 0, "model": m},
                             {"data": 1, "model": 2})
    for a in ARCHS:
        res[f"{a}/pair"] = _train(a, groups)
        res[f"{a}/serve"] = _serve(a, pair, groups.coords, groups.sizes)
    res["coords"] = groups.coords
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_recurrent")
    mesh.spawn_ranks(_ranks, 4, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def one():
    out = {}
    for a in ARCHS:
        out[f"{a}/train"] = _train(a)
        out[f"{a}/serve"] = _serve(a)
    return out


def _quant_close(got, want):
    """Activation leaves bit for bit, gradient leaves within 1e-5 of the
    leaf's largest element; returns the number of gradient leaves."""
    bad, n = [], []

    def cmp(path, a, b):
        if "grad" in path:
            n.append(path)
            tol = 1e-5 * float(b.abs().max())
            if float((a - b).abs().max()) > tol:
                bad.append(path)
        elif not torch.equal(a, b):
            bad.append(path)
    tree_map_with_path(cmp, got, want)
    assert not bad, bad[:5]
    return len(n)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def _like(arch) -> dict:
    return dict(model.init_params(configs.get_reduced(arch), seed=0,
                                  device="cpu").named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", ["mesh", "pair"])
def test_tp_recurrent_train_step_matches_one_process(tp, one, arch,
                                                     mesh_name):
    """The sharded step's quant state, loss and (gathered) clipped
    gradients against the one-process step: (2, 2) and (1, 2)."""
    want = one[f"{arch}/train"]
    key = f"{arch}/{mesh_name}"
    for r in range(4):
        got = tp[r][key]
        assert _quant_close(got["quant"], want["quant"]) > 0
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    like = _like(arch)
    for d0 in (0, 2):
        shards = [tp[d0 + m][key]["grads"] for m in range(2)]
        whole = sharding.gather_named(shards, like)
        for k, g in want["grads"].items():
            assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_serve_matches_one_process(tp, one, arch):
    """(1, 2) prefill and greedy decode: the statistics bit for bit, each
    rank's recurrent state its slice of the one-process cache by
    ``sharding.cache_pspecs`` (channels of ``h`` / ``conv``, heads of
    ``state``, a local block's ring slots: its single KV head does not
    split), the logits within 1e-5 relative L2, the greedy tokens
    identical."""
    want = one[f"{arch}/serve"]
    specs = sharding.cache_pspecs(want["cache"], {"data": 1, "model": 2},
                                  ("data",))

    def model_dims(path):
        sp = specs
        for k in path:
            sp = sp[k]
        return [d for d, ax in enumerate(sp) if ax == "model"]
    for r in range(4):
        got, m = tp[r][f"{arch}/serve"], tp[r]["coords"]["model"]
        bad = []
        tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                           else bad.append(p), got["stats"], want["stats"])
        assert not bad, bad[:5]

        def cache(path, a, b):
            for d in model_dims(path):
                n = b.shape[d] // 2
                b = b.narrow(d, m * n, n)
            if not torch.equal(a, b):
                bad.append(path)
        tree_map_with_path(cache, got["cache"], want["cache"])
        assert not bad, bad[:5]
        for a, b in zip(got["logits"], want["logits"]):
            assert _rel_l2(a, b) <= 1e-5
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_gather_params_round_trips(tp, arch):
    """The (1, 2) ranks' parameters after the step, joined by
    ``gather_params``, are one tree shaped like the full one, and
    sharding it again gives each rank's shards back bit for bit."""
    cfg = configs.get_reduced(arch)
    full = model.init_params(cfg, seed=0, device="cpu")
    for d0 in (0, 2):
        shards = [tp[d0 + m][f"{arch}/pair"]["params"] for m in range(2)]
        back = sharding.gather_params(shards, full)
        for (k, a), b in zip(full.named_parameters(), back.parameters()):
            assert a.shape == b.shape, k
        for m in range(2):
            again = sharding.shard_params(back, {"model": m}, {"model": 2})
            for (k, a), b in zip(shards[m].named_parameters(),
                                 again.parameters()):
                assert torch.equal(a, b), k


@pytest.mark.parametrize("msize", [2, 4])
def test_recurrent_rules_cut_the_reference_dims(msize):
    """``compute_dim`` of the ``/rglru/``, ``/time/`` and ``/chan/``
    leaves: the reference rule table's ``model`` dims (column-parallel
    ``w_in`` / ``w_gate`` / ``w_r`` ..., row-parallel ``w_out`` / ``w_o``
    / ``w_v``, input channels of ``w_a`` / ``w_x``, the channels of the
    conv and gates), everything else whole; shards round-trip."""
    want = {"rglru.w_in": 1, "rglru.w_gate": 1, "rglru.w_out": 0,
            "rglru.w_a": 0, "rglru.w_x": 0, "rglru.conv_w": 1,
            "rglru.conv_b": 0, "rglru.b_a": 0, "rglru.b_x": 0,
            "rglru.lambda": 0, "time.w_r": 1, "time.w_k": 1, "time.w_v": 1,
            "time.w_g": 1, "time.w_o": 0, "time.u": None, "time.w0": None,
            "time.A_w": None, "time.B_w": None, "time.mu": None,
            "time.mu_x": None, "time.A_mix": None, "time.B_mix": None,
            "time.ln_x_scale": None, "time.ln_x_bias": None,
            "chan.w_k": 1, "chan.w_r": 1, "chan.w_v": 0, "chan.mu_k": None,
            "chan.mu_r": None}
    seen = set()
    for arch in ARCHS:
        full = model.init_params(configs.get_reduced(arch), seed=0,
                                 device="cpu")
        shards = [sharding.shard_params(full, {"model": m},
                                        {"model": msize})
                  for m in range(msize)]
        for k, p in shards[0].named_parameters():
            tail = ".".join(k.split(".")[-2:])
            if tail in want:
                seen.add(tail)
                assert sharding.model_dim_of(p) == want[tail], k
        back = sharding.gather_params(shards, full)
        for (k, a), b in zip(full.named_parameters(), back.parameters()):
            assert torch.equal(a, b), k
    assert seen == set(want), set(want) - seen
