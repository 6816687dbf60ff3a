"""The ``model`` mesh axis (Megatron pairs, expert parallelism, the
vocab-parallel embedding and head) on gloo ranks against the port's
one-process step and serve path, on the CPU, plus its unit pieces.

One module fixture spawns 4 ranks once (``launch.mesh.spawn_ranks``, a
FileStore under a temporary directory): they run reduced
qwen2-moe-a2.7b's train step on a ``(data 2, model 2)`` mesh
(``launch.mesh.mesh_groups``: the reference SPMD test's arch, EP plus
dispatch), then, as two ``(1, 2)`` meshes of ranks {0, 1} and {2, 3},
reduced starcoder2-3b's train step, its prefill and greedy decode, and
the unit checks that need a model group (the vocab-parallel cross
entropy, the expert-parallel MoE layer, the width-10 counters).  Each
rank saves what it got; the tests hold that against one process here.
Hindsight W8A8G8 on the fused backend (the kernels' plain versions on
the CPU), from a fresh state (the first-batch ranges), batch 4 x 32.

Bounds:
  * activation-site quant state: bit for bit (the forward is exact: the
    int8 products are exact integers, a row-parallel product sums int32
    partials before its one fp32 rounding, the lookup and the experts'
    dispatch and gather move values, and the ranges combine by min/max);
  * gradient-site quant state: within 1e-5 of each leaf's largest
    element (the backward sums a column-parallel ``dx`` over the model
    group in fp32, in another order than one product);
  * the loss: within 1e-5 relative (the cross entropy's sums over the
    vocabulary run per shard); against the reference's single-device
    ``loss_fn`` on the same parameters and batch, the one-process train
    tests' 3e-3 relative (``tests/test_torch_train.py``; the reference's
    own SPMD bar is 1e-2);
  * parameter gradients (clipped): within 2**-7 relative L2 of each
    tensor, as ``chip_smoke.py`` phase 40 holds data parallelism;
  * serve: the caches (the rank's heads) and the prefill statistics bit
    for bit, the logits within 1e-5 relative L2, the greedy tokens
    identical.

This module imports JAX only inside the test that runs the reference:
the rank processes import it.
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
from repro_torch.telemetry.config import T_N

B, S, LR, GEN = 4, 32, 1e-3, 3
MOE, DENSE = "qwen2-moe-a2.7b", "starcoder2-3b"
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
    """One AdamW step from seed 0; returns the loss, the quant state and
    the gradients (a rank's shards under ``groups``)."""
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
            "grads": opt.grads}


def _serve(arch, model_group=None, coords=None, sizes=None):
    """Prefill (statistics returned) and GEN greedy decode steps."""
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
    out = {"logits": [logits], "stats": stats, "tokens": []}
    out["cache"] = {k: v.clone() for k, v in
                    caches["decoder"]["layers"][0]["kv"].items()}
    for i in range(GEN):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        pos = torch.full((B,), S + i, dtype=torch.long)
        logits, caches = decode(params, quant, {"token": tok[:, None],
                                                "pos": pos}, caches)
        out["logits"].append(logits)
    return out


def _units(rank_in_pair: int):
    """What needs a model group of 2 but no model: the vocab-parallel
    cross entropy, the expert-parallel MoE layer, a width-10 forward."""
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator().manual_seed(7)
    logits = torch.randn((2, 5, 16), generator=gen) * 3
    labels = torch.randint(0, 16, (2, 5), generator=gen)
    mask = torch.ones((2, 5))
    ce = model._chunk_loss(sharding.mp_slice(logits, 2), labels, mask, 16)
    cfg = configs.get_reduced(MOE)
    full = model.init_params(cfg, seed=0, device="cpu")
    part = sharding.shard_params(full, {"model": rank_in_pair},
                                 {"model": 2})
    sites = model.init_quant_state(cfg, POLICY, device="cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=gen).to(torch.bfloat16)
    leaf = sites["decoder"]["layers"][0]["moe"]
    y, mstats, _ = moe_mod.apply_moe(part["decoder"]["layers"][0]["moe"],
                                     leaf, x, cfg.moe, policy=POLICY, seed=3,
                                     step=0)
    # width 10 (telemetry on): a forward's statistics, combined over the
    # model group as the train step combines them
    tele = QuantPolicy.w8a8g8(backend="fused").with_telemetry(enabled=True)
    quant10 = model.init_quant_state(cfg, tele, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    with torch.no_grad():
        _, (fwd, _) = model.loss_fn(part, quant10, batch, cfg, tele, 0, 0)
    return {"ce": ce, "moe_y": y, "moe_stats": mstats,
            "tele": steps.dp_combine_stats(fwd, sharding._MP[0])}


def _ranks(rank, world, out_dir):
    import torch.distributed as dist
    res = {"moe": _train(MOE, mesh.mesh_groups(2, 2))}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair, m = pairs[rank // 2], rank % 2
    groups = mesh.MeshGroups(None, pair, {"data": 0, "model": m},
                             {"data": 1, "model": 2})
    res["dense"] = _train(DENSE, groups)
    res["serve"] = _serve(DENSE, pair, groups.coords, groups.sizes)
    with sharding.model_parallel(pair):
        res["units"] = _units(m)
    res["coords"] = groups.coords
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    mesh.spawn_ranks(_ranks, 4, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def one():
    return {"moe": _train(MOE), "dense": _train(DENSE),
            "serve": _serve(DENSE)}


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


@pytest.mark.parametrize("name, ranks", [("moe", range(4)),
                                         ("dense", range(4))])
def test_tp_train_step_matches_one_process(tp, one, name, ranks):
    """The sharded step's quant state, loss and (gathered) clipped
    gradients against the one-process step: (2, 2) for qwen2-moe-a2.7b,
    (1, 2) for starcoder2-3b."""
    want = one[name]
    for r in ranks:
        got = tp[r][name]
        assert _quant_close(got["quant"], want["quant"]) > 0
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    data_ranks = (0, 2) if name == "moe" else (0,)
    like = dict(model.init_params(configs.get_reduced(
        MOE if name == "moe" else DENSE), seed=0,
        device="cpu").named_parameters())
    for d0 in data_ranks:
        shards = [tp[d0 + m][name]["grads"] for m in range(2)]
        whole = sharding.gather_named(shards, like)
        for k, g in want["grads"].items():
            assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))
    # the data ranks' parameter shards: model rank m's of both data ranks
    # agree bit for bit (their reduced gradients are one all_reduce's)
    if name == "moe":
        for k, g in tp[0][name]["grads"].items():
            assert torch.equal(g, tp[2][name]["grads"][k]), k


def test_tp_moe_loss_to_reference(tp):
    """The (2, 2) step's loss against the reference's single-device
    ``loss_fn`` on the same parameters and batch: the one-process train
    tests' bar (3e-3 relative), inside the reference SPMD test's 1e-2."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import configs as jconfigs
    from repro.core.policy import QuantPolicy as JPolicy
    from repro.models import model as jmodel
    from repro_torch import convert

    cfg = configs.get_reduced(MOE)
    params = model.init_params(cfg, seed=0, device="cpu")
    quant = model.init_quant_state(cfg, POLICY, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    loss_j, _ = jax.jit(lambda p, q, b: jmodel.loss_fn(
        p, q, b, jconfigs.get_reduced(MOE), JPolicy.w8a8g8(), jnp.int32(0),
        jnp.int32(0)))(
        jax.tree_util.tree_map(jnp.asarray,
                               convert.params_to_jax(params, cfg)),
        jax.tree_util.tree_map(jnp.asarray,
                               convert.to_jax_layout(quant, cfg)),
        {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()})
    for r in range(4):
        got = tp[r]["moe"]["loss"]
        assert abs(got - float(loss_j)) <= 3e-3 * abs(float(loss_j)), (
            got, float(loss_j))


def test_tp_serve_matches_one_process(tp, one):
    """(1, 2) prefill and greedy decode of starcoder2-3b: the statistics
    and each rank's cache heads (and its slots of ``pos``, the reference
    ``cache_pspecs``' pos rule: 2 divides the 32 slots) bit for bit, the
    logits within 1e-5 relative L2, the greedy tokens identical."""
    want = one["serve"]
    for r in range(4):
        got, m = tp[r]["serve"], tp[r]["coords"]["model"]
        bad = []
        tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                           else bad.append(p), got["stats"], want["stats"])
        assert not bad, bad[:5]
        for k in ("k", "v"):
            n = got["cache"][k].shape[2]
            assert torch.equal(got["cache"][k],
                               want["cache"][k][:, :, m * n:(m + 1) * n]), k
        n = got["cache"]["pos"].shape[1]
        assert 2 * n == want["cache"]["pos"].shape[1]
        assert torch.equal(got["cache"]["pos"],
                           want["cache"]["pos"][:, m * n:(m + 1) * n])
        for a, b in zip(got["logits"], want["logits"]):
            assert _rel_l2(a, b) <= 1e-5
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)


def test_vocab_parallel_cross_entropy_equals_full(tp):
    """Each rank's vocabulary half through ``model._chunk_loss`` under a
    model group of 2 gives the full cross entropy and z-penalty."""
    gen = torch.Generator().manual_seed(7)
    logits = torch.randn((2, 5, 16), generator=gen) * 3
    labels = torch.randint(0, 16, (2, 5), generator=gen)
    want = model._chunk_loss(logits, labels, torch.ones((2, 5)), 16)
    for r in range(4):
        for a, b in zip(tp[r]["units"]["ce"], want):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)), (a, b)


def test_expert_parallel_layer_equals_full_moe(tp):
    """``apply_moe`` on a rank's 4 of 8 experts (dispatch sliced along E,
    the outputs gathered for the combine) against the one-process layer on
    all 8: the output bit for bit, the statistics the same after the
    model group's min/max."""
    from repro_torch.models import moe as moe_mod
    cfg = configs.get_reduced(MOE)
    gen = torch.Generator().manual_seed(7)
    torch.randn((2, 5, 16), generator=gen)
    torch.randint(0, 16, (2, 5), generator=gen)
    x = torch.randn((2, 32, cfg.d_model), generator=gen).to(torch.bfloat16)
    full = model.init_params(cfg, seed=0, device="cpu")
    sites = model.init_quant_state(cfg, POLICY, device="cpu")
    y, stats, _ = moe_mod.apply_moe(full["decoder"]["layers"][0]["moe"],
                                    sites["decoder"]["layers"][0]["moe"], x,
                                    cfg.moe, policy=POLICY, seed=3, step=0)
    for r in range(4):
        u = tp[r]["units"]
        assert torch.equal(u["moe_y"], y)
    for pair in ((0, 1), (2, 3)):
        a, b = (tp[r]["units"]["moe_stats"] for r in pair)
        got = tree_map_with_path(
            lambda p, s, t: torch.stack([torch.minimum(s[0], t[0]),
                                         torch.maximum(s[1], t[1]),
                                         torch.maximum(s[2], t[2])]), a, b)
        bad = []
        tree_map_with_path(lambda p, s, t: None if torch.equal(s, t)
                           else bad.append(p), got, stats)
        assert not bad, bad


def test_width10_counters_count_replicated_sites_once(tp):
    """A telemetry (width-10) forward on a model group of 2, combined over
    it: every site's element count ``n`` is the one-process count (a site
    both ranks hold whole counts once, a sharded site's halves add up),
    and min/max/visited are the one-process values."""
    cfg = configs.get_reduced(MOE)
    tele = QuantPolicy.w8a8g8(backend="fused").with_telemetry(enabled=True)
    params = model.init_params(cfg, seed=0, device="cpu")
    quant = model.init_quant_state(cfg, tele, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    with torch.no_grad():
        _, (want, _) = model.loss_fn(params, quant, batch, cfg, tele, 0, 0)
    visited = [0]

    def cmp(path, a, b):
        assert a.shape[-1] == 10, path
        assert torch.equal(a[:3], b[:3]), path
        assert float(a[T_N]) == float(b[T_N]), (path, a[T_N], b[T_N])
        visited[0] += int(b[2] > 0.5)
    for r in range(4):
        tree_map_with_path(cmp, tp[r]["units"]["tele"], want)
    assert visited[0] > 0


@pytest.mark.parametrize("msize", [2, 4])
def test_attn_layout_for_every_config(msize):
    """``attn_layout`` picks a head layout for each of the ten configs at
    model 2 and 4 (KV where it divides, else G), as ``choose_head_axis``
    ranks them; a split that neither divides pads the dim
    ``choose_head_axis`` picks."""
    for name in configs.names():
        cfg = configs.get(name)
        kv, g = cfg.n_kv, cfg.n_heads // cfg.n_kv
        layout = sharding.attn_layout(kv, g, msize)
        assert layout == ("kv" if kv % msize == 0 else "g"), name
        assert layout == sharding.choose_head_axis(kv, g, msize)
    assert sharding.attn_layout(2, 3, 4) == "g_pad"
    assert sharding.attn_layout(3, 2, 4) == "kv_pad"
    assert sharding.attn_layout(3, 3, 4) == "g_pad"


def test_shard_noise_is_the_global_noise_slice(monkeypatch):
    """A gradient site sharded along its model dim (and its batch rows)
    draws this rank's slice of the global site's noise."""
    from repro_torch.core import backend
    full = backend.site_noise(11, (4, 6, 8), "cpu")
    for m in range(2):
        monkeypatch.setattr(sharding, "_MP", (None, m, 2))
        got = backend.shard_noise(11, (4, 3, 8), "cpu", model_dim=1)
        assert torch.equal(got, full[:, 3 * m:3 * (m + 1)])
        for d in range(2):
            monkeypatch.setattr(sharding, "_DP", (None, d, 2))
            got = backend.shard_noise(11, (2, 3, 8), "cpu", 0, 1)
            assert torch.equal(got, full[2 * d:2 * (d + 1),
                                         3 * m:3 * (m + 1)])
        monkeypatch.setattr(sharding, "_DP", None)
    monkeypatch.setattr(sharding, "_MP", (None, 1, 2))
    assert torch.equal(backend.shard_noise(11, (4, 6, 8), "cpu"), full)


@pytest.mark.parametrize("espec, xs, ws", [
    ("...k,kn->...n", (2, 7, 48), (48, 24)),
    ("bskgh,kghd->bsd", (2, 5, 4, 3, 16), (4, 3, 16, 40))])
def test_row_parallel_int32_partials_equal_the_product(espec, xs, ws):
    """K split into two shards in one process: the int32 mode's partials
    (each with its own K rows' zero-point correction), summed, through the
    epilogue, equal the unsharded ``int8_matmul_fp`` bit for bit, values
    and (min, max)."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(len(xs))
    x = torch.randint(0, 256, xs, generator=gen, dtype=torch.uint8)
    w = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
    zp, alpha = torch.tensor(117.3), torch.tensor(3.1e-4)
    lhs, _ = espec.split("->")
    xl, wl = lhs.replace("...", "Z").split(",")
    kdims = [c for c in wl if c in xl and c not in espec.split("->")[1]]
    plan = ops.plan_einsum(espec, x.ndim, w.ndim)
    want, mn, mx = ops.int8_matmul_fp(x, w, zp, alpha, plan=plan)
    d = kdims[0]
    xd, wd = xl.index(d) + (x.ndim - len(xl)), wl.index(d)
    n = x.shape[xd] // 2
    acc = sum(ops.int8_matmul_int32(x.narrow(xd, i * n, n),
                                    w.narrow(wd, i * n, n), zp, plan=plan)
              for i in range(2))
    assert acc.dtype == torch.int32
    y, gmn, gmx = ops.int8_matmul_epilogue(acc, alpha)
    assert torch.equal(y, want)
    assert torch.equal(gmn, mn) and torch.equal(gmx, mx)


def test_shard_and_gather_params_round_trip():
    """``shard_params`` at model 2 and 4 then ``gather_params`` gives the
    tree back; the cut dims are recorded on the shards; the storage-only
    and frontend leaves stay whole."""
    cfg = configs.get_reduced(MOE)
    full = model.init_params(cfg, seed=0, device="cpu")
    for msize in (2, 4):
        shards = [sharding.shard_params(full, {"model": m},
                                        {"model": msize})
                  for m in range(msize)]
        back = sharding.gather_params(shards, full)
        for (k, a), b in zip(full.named_parameters(), back.parameters()):
            assert torch.equal(a, b), k
        dims = {k: sharding.model_dim_of(p)
                for k, p in shards[0].named_parameters()}
        assert dims["embed"] == 0 and dims["head"] == 1
        assert dims["decoder.layers.0.moe.w_up"] == 0
        assert dims["decoder.layers.0.moe.shared.w_up"] == 1
        assert dims["decoder.layers.0.moe.router"] is None
        assert dims["decoder.layers.0.attn.wq"] == 1
        assert dims["final_norm.scale"] is None
    vcfg = configs.get_reduced("paligemma-3b")
    p = sharding.shard_params(model.init_params(vcfg, seed=0, device="cpu"),
                              {"model": 1}, {"model": 2})
    named = dict(p.named_parameters())
    assert sharding.model_dim_of(named["patch_proj"]) is None
    assert sharding.model_dim_of(named["decoder.layers.0.attn.wq"]) == 2


def test_rec_and_rwkv_blocks_raise_under_a_model_group(monkeypatch):
    """The recurrent kinds run under a model group on their channel or
    head shards (``tests/test_torch_tp_recurrent.py``); they raise where
    those do not split over the group: their parameters' cut names the
    leaf, their caches the dim."""
    from repro_torch.models import transformer
    for arch, kind, what in (("recurrentgemma-9b", "rec", "lru_width"),
                             ("rwkv6-7b", "rwkv", "rwkv heads")):
        cfg = configs.get_reduced(arch)
        full = model.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="does not split over 3"):
            sharding.shard_params(full, {"model": 0}, {"model": 3})
        monkeypatch.setattr(sharding, "_MP", (None, 0, 3))
        with pytest.raises(ValueError, match=what):
            transformer._init_block_cache(kind, cfg, 2, 8)
        monkeypatch.setattr(sharding, "_MP", (None, 0, 2))
        assert transformer._init_block_cache(kind, cfg, 2, 8)
        monkeypatch.setattr(sharding, "_MP", None)
