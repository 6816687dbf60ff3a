"""ZeRO-3 storage on the data axis (``sharding.store_state``: parameter
and optimizer shares, the weight gathered at its use, the gradient
reduce-scattered, a save from shares), the model axis's uneven expert and
vocabulary shares, and the ``dsgc`` estimator under the data and model
groups, on gloo ranks against the port's one-process program, on the CPU.

One module fixture spawns 4 ranks once (``launch.mesh.spawn_ranks``, a
FileStore under a temporary directory).  They run, in turn:

* reduced qwen2-moe-a2.7b's train step from a stored state on a ``(2,
  2)`` mesh (ZeRO-3 with expert parallelism: the layout of the
  reference's ``test_spmd_train_step_matches_single_device``);
* as two pairs, {0, 1} and {2, 3}, reduced starcoder2-3b's stored train
  step on ``(2, 1)`` with ``int8_weight_gather`` off (pair 0) and on
  (pair 1); pair 0 then serves a prefill and 2 greedy decode steps on
  the stored parameters and saves its state from the shares, which the
  ranks restore into their stored layout; then a ``dsgc`` train step
  (simulated backend) on ``(2, 1)`` (pair 0) and on ``(1, 2)`` (pair 1);
  pair 1 then steps reduced paligemma-3b and seamless-m4t-medium stored
  on ``(1, 2)`` (``patch_proj`` / ``enc_in`` over the model group);
* ranks {0, 1, 2} as a ``(1, 3)`` mesh: reduced qwen2-moe-a2.7b with 4
  experts (shares 2, 2 and 0: rank 2 holds none) and its vocabulary of
  512 (171, 171, 170), served and trained on model-axis shards.

Each rank saves what it got; the tests hold it against one process here.
Bounds, as ``tests/test_torch_dp.py`` and ``tests/test_torch_tp.py``
state and explain them:

* quant state: on the data axis bit for bit; where the model axis is
  split, activation leaves bit for bit and gradient leaves within 1e-5 of
  the leaf's largest element;
* parameters after one AdamW step: every element within 2 lr (AdamW's
  first update is sign-like: this bar would pass a gradient of any
  positive scale, so the gradients are held too);
* the gradients, each rank rounding its half's bf16 contraction before
  the fp32 sum (2**-8 is one bf16 rounding): each leaf's clipped
  gradient, the ranks' shares joined, within 2**-7 of its largest
  element (``tests/test_torch_dp.py``'s SGD bar on the update, in
  gradient units), and the global norm before clipping within 2**-7
  relative (the step clips at 1.0 and these norms are above 2, so a
  gradient off by a constant factor, such as a mean in place of the sum,
  shows in the norm and not in the clipped gradients);
* the loss within 1e-5 relative; the model-axis gradients within 2**-7
  relative L2;
* serve: statistics, logits and greedy tokens bit for bit on the data
  axis (the gather moves values); on the uneven model axis the statistics
  bit for bit, the logits within 1e-5 relative L2, the tokens identical;
* ``dsgc``: at each site the sharded search's path against the
  one-process search's on the same (gathered) tensor, iteration by
  iteration up to the first whose choice between its two probes
  differs: the probes bit for bit (``max|x|`` is exact) and the
  objective ``1 - cos(x, Q(x; -c, c))`` at each within ``PATH_BAR``.
  The sharded objective sums its three fp32 partials in another order.
  Each sum of ~1e4 terms then moves by up to about ``log2(n) * 2**-24``
  ~ 1e-6 relative, and the objective by the dot's move less the norms'
  halves: 3.4e-6 at most here, above 1e-6, so the bar is 1e-5.  A
  search that sums only its own piece, or takes its own ``max|x|``,
  fails it (a mutated copy of each).  The moved sums can flip a near-tie
  between the two probes (the one-process probes' objectives within 2e-5
  at the flip); near the minimum the probes' objectives differ by less
  than that rounding (``1 - cos`` is ~1e-4 at 8 bits), so the late
  iterations choose on rounding and a flip leads to another point of the
  jagged floor.  A search with no flip ends on the one-process threshold
  bit for bit.  After a flip, the
  objective at the two thresholds within the larger of 1e-6 and
  ``FLOOR_MARGIN`` times the one-process search's own floor, and the
  thresholds within the larger of ``DSGC_BAR`` of ``max|x|`` and
  ``FLOOR_MARGIN`` times the floor's threshold move.  The floor: the
  one-process search on its own tensor with the elements reversed (the
  same sums, another order) against the search on the tensor (2.7e-6
  of the objective and 2.8% of ``max|x|`` at most at these sizes), held
  below ``FLOOR_CAP``.

Structural checks without ranks: every leaf of the ten configs at ``(16,
16)`` and ``(2, 2)`` from shapes alone (the stored numel a rank against
the reference's ``param_pspecs`` rule, every leaf covered once), the
model axis's ``compute_dim`` defined for the ten configs at model 2, 4,
8 and 16, and ``compress`` refusing a stored state.

This module imports JAX only inside the tests that read the reference:
the rank processes import it.
"""
import dataclasses

import numpy as np
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

B, S, LR, GEN = 4, 32, 1e-3, 2
MOE, DENSE = "qwen2-moe-a2.7b", "starcoder2-3b"
VLM, ENCDEC = "paligemma-3b", "seamless-m4t-medium"
POLICY = QuantPolicy.w8a8g8(backend="fused")
GATHER = dataclasses.replace(POLICY, int8_weight_gather=True)
DSGC = QuantPolicy.w8a8g8(act_kind="dsgc", grad_kind="dsgc")
# dsgc's bars (module docstring): the thresholds' least bar in units of
# the tensor's max|x|, the margin over the one-process search's floor and
# the cap on that floor's objective distance
DSGC_BAR, FLOOR_MARGIN, FLOOR_CAP = 2e-2, 4.0, 1e-5
# the bar on the objective at the same probe, sharded against one process
PATH_BAR = 1e-5


def _uneven_cfg():
    """Reduced qwen2-moe-a2.7b with 4 experts, its shared expert's d_ff
    96 (a Megatron pair: it must split over 3 ranks)."""
    cfg = configs.get_reduced(MOE)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=4, d_shared=96))


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


def _train(cfg, pol, groups=None, stored=True):
    """One AdamW step from seed 0: the loss, quant state, the global
    gradient norm before clipping, the (clipped) gradients handed to the
    optimizer and the state (a rank's stored shares, or its model shards
    without ``stored``)."""
    opt = _Spy(adamw())
    st = steps.init_train_state(cfg, opt, pol, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        if stored:
            st = sharding.store_state(st, groups.coords, groups.sizes)
        else:
            st = steps.train_state(sharding.shard_params(
                st["params"], groups.coords, groups.sizes), st["quant"], opt)
        kw = dict(group=groups.data, model_group=groups.model)
    ts = steps.make_train_step(cfg, pol, opt, constant(LR), **kw)
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "norm": float(met["grad_norm"]), "grads": opt.grads, "state": st}


def _serve(cfg, pol, params, groups=None):
    """Prefill (statistics returned) and GEN greedy decode steps."""
    kw = {} if groups is None else dict(group=groups.data,
                                        model_group=groups.model)
    quant = model.init_quant_state(cfg, pol, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=1).batch(0)
    prefill = steps.make_prefill_step(cfg, pol, cache_len=S + GEN,
                                      return_stats=True, **kw)
    decode = steps.make_decode_step(cfg, pol, **kw)
    logits, caches, stats = prefill(params, quant,
                                    {"tokens": batch["tokens"]})
    out = {"logits": [logits], "stats": stats, "tokens": []}
    for i in range(GEN):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        pos = torch.full((B,), S + i, dtype=torch.long)
        logits, caches = decode(params, quant, {"token": tok[:, None],
                                                "pos": pos}, caches)
        out["logits"].append(logits)
    return out


class _Trace:
    """Records a ``dsgc_search``'s path: each probe ``c`` it quantizes at
    and each objective it reads, in order (two of each an iteration)."""

    def __init__(self):
        from repro_torch.core import estimators
        self.q, self.probes, self.f = estimators.quant, [], []
        self.real = {k: getattr(self.q, k) for k in
                     ("fake_quant_raw", "cosine_distance",
                      "cosine_from_sums")}

    def __enter__(self):
        def probe(x, lo, hi, spec):
            self.probes.append(float(hi))
            return self.real["fake_quant_raw"](x, lo, hi, spec)

        def objective(name):
            def fn(*a):
                out = self.real[name](*a)
                self.f.append(float(out))
                return out
            return fn
        self.q.fake_quant_raw = probe
        for k in ("cosine_distance", "cosine_from_sums"):
            setattr(self.q, k, objective(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.q, k, fn)


class _Searches:
    """Records each ``dsgc_search`` as ``(c, c1, f(c), f(c1), max|x|, c2,
    f(c2), path, path1)``: its threshold ``c``; ``c1``, the one-process
    search's on the whole tensor (the site's pieces gathered over its
    groups, flattened); ``c2``, the one-process search's on that tensor
    reversed (the floor); the one-process objective ``f`` on the whole
    tensor; the two searches' paths (:class:`_Trace`, ``(probes,
    objectives)``)."""

    def __init__(self):
        from repro_torch.core import estimators
        self.mod, self.real, self.calls = estimators, \
            estimators.dsgc_search, []

    def __enter__(self):
        def spy(x, spec, iters=20, split_model=False):
            with _Trace() as path:
                lo, hi = self.real(x, spec, iters, split_model)
            whole = _gathered(x, sharding.site_groups(split_model))
            dp, sharding._DP = sharding._DP, None   # the one-process search
            try:
                with _Trace() as path1:
                    c1 = self.real(whole, spec, iters)[1]
                c2 = self.real(whole.flip(0), spec, iters)[1]
            finally:
                sharding._DP = dp
            self.calls.append((float(hi), float(c1), _objective(whole, spec,
                                                                hi),
                               _objective(whole, spec, c1),
                               float(whole.abs().max()), float(c2),
                               _objective(whole, spec, c2),
                               (path.probes, path.f),
                               (path1.probes, path1.f)))
            return lo, hi
        self.mod.dsgc_search = spy
        return self

    def __exit__(self, *exc):
        self.mod.dsgc_search = self.real


def _gathered(x, groups) -> torch.Tensor:
    """The pieces of a site's tensor over ``groups``, flattened and
    joined in rank order."""
    import torch.distributed as dist
    x = x.detach().reshape(-1)
    for g in groups:
        parts = [None] * g[2]
        dist.all_gather_object(parts, x, group=g[0])
        x = torch.cat(parts)
    return x


def _objective(x, spec, c) -> float:
    """The one-process ``1 - cos(x, Q(x; -c, c))``."""
    from repro_torch.core import quant
    det = dataclasses.replace(spec, stochastic=False)
    xf = x.to(torch.float32)
    return float(quant.cosine_distance(
        xf, quant.fake_quant_raw(xf, -c, c, det)))


def _dsgc(cfg, groups=None):
    with _Searches() as rec:
        out = _train(cfg, DSGC, groups, stored=False)
    return {"searches": rec.calls, "quant": out["quant"],
            "loss": out["loss"]}


def _image_dtypes():
    """Spy on ``sharding.gather_stored``: the dtypes it moved."""
    seen, real = [], sharding.gather_stored

    def spy(x, st):
        seen.append(str(x.dtype))
        return real(x, st)
    sharding.gather_stored = spy
    return seen, real


def _ranks(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch import checkpoint
    # one thread a rank: 4 ranks of the machine's threads each wait on
    # one another's collectives ~10x longer
    torch.set_num_threads(1)
    res = {}
    res["moe"] = _train(configs.get_reduced(MOE), POLICY,
                        mesh.mesh_groups(2, 2))
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair, p = pairs[rank // 2], rank % 2
    data_pair = mesh.MeshGroups(pair, None, {"data": p, "model": 0},
                                {"data": 2, "model": 1})
    model_pair = mesh.MeshGroups(None, pair, {"data": 0, "model": p},
                                 {"data": 1, "model": 2})
    trio = dist.new_group([0, 1, 2])
    dense = configs.get_reduced(DENSE)
    pol = POLICY if rank < 2 else GATHER
    seen, real = _image_dtypes()
    try:
        res["dense"] = _train(dense, pol, data_pair)
    finally:
        sharding.gather_stored = real
    res["dense"]["moved"] = sorted(set(seen))
    if rank < 2:
        st = res["dense"]["state"]
        res["serve"] = _serve(dense, POLICY, sharding.store_params(
            model.init_params(dense, seed=0, device="cpu"),
            data_pair.coords, data_pair.sizes), data_pair)
        ck = f"{out_dir}/ckpt"
        fresh = sharding.store_state(
            steps.init_train_state(dense, adamw(), seed=0, device="cpu"),
            data_pair.coords, data_pair.sizes)
        checkpoint.save(ck, 0, fresh, groups=data_pair)
        checkpoint.save(ck, 1, st, groups=data_pair)
        back = checkpoint.restore(ck, 1, st)
        res["restored"] = {k: (torch.equal(t, dict(
            st["params"].named_parameters())[k]), sharding.stored_of(t))
            for k, t in back["params"].named_parameters()}
        res["restored_opt"] = all(
            torch.equal(back["opt"][m][k], st["opt"][m][k])
            and sharding.stored_of(back["opt"][m][k]) is not None
            for m in ("m", "v") for k in st["opt"][m])
    res["dsgc"] = _dsgc(dense, data_pair if rank < 2 else model_pair)
    if rank >= 2:       # "model"-only storage on (1, 2)
        res["vlm"] = _train(configs.get_reduced(VLM), POLICY, model_pair)
        res["encdec"] = _train(configs.get_reduced(ENCDEC), POLICY,
                               model_pair)
        res["encdec_shards"] = _train(configs.get_reduced(ENCDEC), POLICY,
                                      model_pair, stored=False)
    if rank < 3:
        trio_g = mesh.MeshGroups(None, trio, {"data": 0, "model": rank},
                                 {"data": 1, "model": 3})
        cfg = _uneven_cfg()
        params = sharding.shard_params(model.init_params(cfg, seed=0,
                                                         device="cpu"),
                                       trio_g.coords, trio_g.sizes)
        res["uneven_serve"] = _serve(cfg, POLICY, params, trio_g)
        res["uneven_train"] = _train(cfg, POLICY, trio_g, stored=False)
        res["uneven_shapes"] = {k: tuple(v.shape)
                                for k, v in params.named_parameters()}
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()


@pytest.fixture(scope="module")
def z3(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero3")
    mesh.spawn_ranks(_ranks, 4, d / "store", args=(str(d),))
    out = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    for r in out:
        r["ckpt"] = str(d / "ckpt")
    return out


@pytest.fixture(scope="module")
def one():
    dense = configs.get_reduced(DENSE)
    base = _train(dense, POLICY)
    return {"moe": _train(configs.get_reduced(MOE), POLICY),
            "dense": base, "dense_gather": _train(dense, GATHER),
            "serve": _serve(dense, POLICY, model.init_params(
                dense, seed=0, device="cpu")),
            "dsgc": _dsgc(dense),
            "uneven_serve": _serve(_uneven_cfg(), POLICY, model.init_params(
                _uneven_cfg(), seed=0, device="cpu")),
            "uneven_train": _train(_uneven_cfg(), POLICY),
            "vlm": _train(configs.get_reduced(VLM), POLICY)}


def _quant_close(got, want, exact: bool) -> int:
    """Activation leaves bit for bit; gradient leaves bit for bit where
    ``exact``, else within 1e-5 of the leaf's largest element; returns
    the number of visited leaves."""
    bad, n = [], []

    def cmp(path, a, b):
        n.append(int(b[2] > 0.5))
        if "grad" in path and not exact:
            if float((a - b).abs().max()) > 1e-5 * float(b.abs().max()):
                bad.append(path)
        elif not torch.equal(a, b):
            bad.append(path)
    tree_map_with_path(cmp, got, want)
    assert not bad, bad[:5]
    return sum(n)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def _whole_params(ranks: list, key: str) -> dict:
    states = [r[key]["state"] for r in ranks]
    return dict(sharding.gather_state(states)["params"].named_parameters())


def _whole_grads(ranks: list, key: str) -> dict:
    """The ranks' gradient shares (each its parameter's stored share)
    joined into whole gradients."""
    named = [dict(r[key]["state"]["params"].named_parameters())
             for r in ranks]
    return {k: sharding._whole_of([r[key]["grads"][k] for r in ranks],
                                  [sharding.stored_of(n[k]) for n in named])
            for k in named[0]}


def _grads_close(ranks: list, key: str, want: dict) -> None:
    """The global norm and the joined clipped gradients against ``want``
    (a run's ``_train`` result, or ``{"norm", "grads"}``), to the bars of
    the module docstring."""
    for r in ranks:
        d = abs(r[key]["norm"] - want["norm"])
        assert d <= 2 ** -7 * want["norm"], (r[key]["norm"], want["norm"])
    whole = _whole_grads(ranks, key)
    assert sorted(whole) == sorted(want["grads"])
    for k, g in want["grads"].items():
        d = float((whole[k] - g).abs().max())
        assert d <= 2 ** -7 * float(g.abs().max()), (key, k, d)


@pytest.mark.parametrize("name, ranks, want", [
    ("moe", (0, 1, 2, 3), "moe"), ("dense", (0, 1), "dense"),
    ("dense", (2, 3), "dense_gather")])
def test_zero3_step_matches_one_process(z3, one, name, ranks, want):
    """A stored state's train step (qwen2-moe-a2.7b on (2, 2) with
    expert parallelism; starcoder2-3b on (2, 1) with ``int8_weight_gather``
    off and on) against the one-process step: the quant state (bit for
    bit on the data axis), the loss, the gradients the optimizer took
    (reduce-scattered onto the shares) and the parameters after one AdamW
    step, the ranks' shares joined by ``gather_state``."""
    w = one[want]
    for r in ranks:
        got = z3[r][name]
        assert _quant_close(got["quant"], w["quant"],
                            exact=name == "dense") > 0
        assert abs(got["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    _grads_close([z3[r] for r in ranks], name, w)
    whole = _whole_params([z3[r] for r in ranks], name)
    for k, p in w["state"]["params"].named_parameters():
        d = float((whole[k] - p).detach().abs().max())
        assert d <= 2 * LR * 1.001, (k, d)


@pytest.mark.parametrize("name, ranks", [("moe", (0, 1, 2, 3)),
                                         ("dense", (0, 1)),
                                         ("dense", (2, 3))])
def test_zero3_rank_stores_its_shares(z3, name, ranks):
    """Each rank holds exactly its ``stored_box`` of every parameter and
    of both AdamW moments (about 1 / D of the data-split leaves), and the
    boxes of the mesh's ranks cover each leaf once."""
    for r in ranks:
        st = z3[r][name]["state"]
        split = 0
        for k, p in st["params"].named_parameters():
            lay = sharding.stored_of(p)
            assert lay is not None, k
            box = sharding.stored_box(lay)
            assert tuple(p.shape) == tuple(n for _, n in box), k
            for m in ("m", "v"):
                assert st["opt"][m][k].shape == p.shape, (k, m)
            split += "data" in lay.axes
        assert split > 0
    whole = sum(np.prod(sharding.stored_of(p).leaf) for p in
                z3[ranks[0]][name]["state"]["params"].parameters())
    for r in ranks:     # D = 2: about half of the leaves' elements
        held = sum(p.numel() for p in
                   z3[r][name]["state"]["params"].parameters())
        assert held < 0.6 * whole, (r, held, whole)


def test_zero3_model_only_storage(z3, one):
    """On ``(1, 2)`` a stored leaf splits over the model group alone:
    ``patch_proj`` / ``enc_in`` (whole for compute) and the grid
    entries of the attention weights.  Reduced paligemma-3b's step
    against one process (``tests/test_torch_tp.py``'s bars, params
    within 2 lr); reduced seamless-m4t-medium's against its own
    model-axis step on unstored shards (its encoder's sequence-parallel
    core keeps gradient leaves off one process by more than 1e-5, stored
    or not): quant state and loss bit for bit, params within 2 lr; both
    steps' gradients to the module docstring's bars."""
    for r in (2, 3):
        lays = {k: sharding.stored_of(p) for k, p in
                z3[r]["vlm"]["state"]["params"].named_parameters()}
        assert lays["patch_proj"].axes == ("model",)
        assert lays["patch_proj"].of_leaf and lays["patch_proj"].dim == 1
        got, want = z3[r]["vlm"], one["vlm"]
        assert _quant_close(got["quant"], want["quant"], exact=False) > 0
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        got, want = z3[r]["encdec"], z3[r]["encdec_shards"]
        enc_in = dict(got["state"]["params"].named_parameters())["enc_in"]
        assert sharding.stored_of(enc_in).axes == ("model",)
        assert _quant_close(got["quant"], want["quant"], exact=True) > 0
        assert got["loss"] == want["loss"]
    ranks = [z3[2], z3[3]]
    _grads_close(ranks, "vlm", one["vlm"])
    like = dict(model.init_params(configs.get_reduced(ENCDEC), seed=0,
                                  device="cpu").named_parameters())
    _grads_close(ranks, "encdec", {
        "norm": z3[2]["encdec_shards"]["norm"],
        "grads": sharding.gather_named(
            [r["encdec_shards"]["grads"] for r in ranks], like)})
    for name, want in (("vlm", dict(one["vlm"]["state"]["params"]
                                    .named_parameters())),
                       ("encdec", sharding.gather_named(
                           [dict(r["encdec_shards"]["state"]["params"]
                                 .named_parameters()) for r in ranks],
                           like))):
        whole = _whole_params([z3[2], z3[3]], name)
        for k, p in want.items():
            d = float((whole[k] - p).detach().abs().max())
            assert d <= 2 * LR * 1.001, (name, k, d)


def test_zero3_int8_image_moves(z3):
    """Under ``int8_weight_gather`` the weights' gathers move the 1-byte
    image; without it, the fp32 shares."""
    for r in (0, 1):
        assert z3[r]["dense"]["moved"] == ["torch.float32"]
    for r in (2, 3):
        assert set(z3[r]["dense"]["moved"]) <= {"torch.int8", "torch.uint8"}
        assert z3[r]["dense"]["moved"]


def test_zero3_serve_on_stored_params(z3, one):
    """A prefill and 2 greedy decode steps on stored parameters (each
    weight gathered at its use over the data pair, no gradient):
    statistics, logits and tokens bit for bit the one-process run's."""
    want = one["serve"]
    for r in (0, 1):
        got = z3[r]["serve"]
        bad = []
        tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                           else bad.append(p), got["stats"], want["stats"])
        assert not bad, bad[:5]
        for a, b in zip(got["logits"], want["logits"]):
            assert torch.equal(a, b)
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)


def test_zero3_save_from_shares(z3, tmp_path):
    """``checkpoint.save(..., groups=)`` from the ranks' shares writes the
    whole-leaf file: a fresh stored state's equals the one-process save
    bit for bit, leaf for leaf, and the state after the step equals the
    ranks' shares joined; restored into the stored layout, each rank gets
    its shares back."""
    from repro_torch import checkpoint
    ck = z3[0]["ckpt"]
    cfg = configs.get_reduced(DENSE)
    ref = str(tmp_path / "one")
    checkpoint.save(ref, 0, steps.init_train_state(cfg, adamw(), seed=0,
                                                   device="cpu"))
    a, b = checkpoint.load_arrays(ck, 0), checkpoint.load_arrays(ref, 0)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    after = checkpoint.load_arrays(ck, 1)
    whole = sharding.gather_state([z3[0]["dense"]["state"],
                                   z3[1]["dense"]["state"]])
    for k, p in whole["params"].named_parameters():
        assert np.array_equal(after["params/" + k.replace(".", "/")],
                              p.detach().numpy()), k
    for m in ("m", "v"):
        for k, t in whole["opt"][m].items():
            assert np.array_equal(after[f"opt/{m}/{k}"], t.numpy()), (m, k)
    for r in (0, 1):
        assert all(ok and lay is not None
                   for ok, lay in z3[r]["restored"].values())
        assert z3[r]["restored_opt"]


def test_zero3_refuses_compress():
    """``compress`` returns replicated gradients (the reference's int8
    all-reduce has no ZeRO-3 form): a step on a stored state with it
    raises."""
    cfg = configs.get_reduced(DENSE)
    st = sharding.store_state(
        steps.init_train_state(cfg, adamw(), POLICY, seed=0, device="cpu"),
        {"data": 0, "model": 0}, {"data": 2, "model": 1})
    ts = steps.make_train_step(cfg, POLICY, adamw(), constant(LR),
                               compress=lambda g, s: (g, s))
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    with pytest.raises(ValueError, match="ZeRO-3"):
        ts(st, batch)


def _first_flip(path, path1) -> int:
    """The first golden-section iteration whose choice (``f1 < f2``)
    differs between two search paths, or the number of iterations."""
    f, f1 = path[1], path1[1]
    for i in range(len(f1) // 2):
        if (f[2 * i] < f[2 * i + 1]) != (f1[2 * i] < f1[2 * i + 1]):
            return i
    return len(f1) // 2


@pytest.mark.parametrize("ranks, mesh_shape", [((0, 1), (2, 1)),
                                               ((2, 3), (1, 2))])
def test_dsgc_step_under_groups(z3, one, ranks, mesh_shape):
    """A ``dsgc`` step (act and grad estimators; simulated backend) on a
    data pair and on a model pair: at every site the sharded search's
    path against the one-process search's on the same (gathered) tensor.
    Up to and including the first iteration whose choice differs, the
    probes bit for bit and the objectives within ``PATH_BAR``, so a
    choice flips only on a near-tie; without a flip the threshold bit
    for bit; after one, to the floor bars of the module docstring.  As
    many searches as the
    one-process step's, whose first (the same input) it matches to the
    same bars."""
    want = one["dsgc"]["searches"]
    assert len(want) > 10
    got = [z3[r]["dsgc"]["searches"] for r in ranks]
    rows = [row for g in got for row in g]
    floor_f = max(abs(row[6] - row[3]) for row in rows)
    floor_c = max(abs(row[5] - row[1]) / row[4] for row in rows)
    assert floor_f <= FLOOR_CAP
    bar_f = max(1e-6, FLOOR_MARGIN * floor_f)
    bar_c = max(DSGC_BAR, FLOOR_MARGIN * floor_c)
    for g in got:
        assert len(g) == len(want)
        for c, c1, f, f1, amax, _, _, path, path1 in g:
            n = _first_flip(path, path1)
            upto = 2 * min(n + 1, len(path1[1]) // 2)
            assert len(path[1]) == len(path1[1]) and upto > 0
            assert path[0][:upto] == path1[0][:upto], (n, c, c1)
            dist = max(abs(a - b) for a, b in zip(path[1][:upto],
                                                  path1[1][:upto]))
            assert dist <= PATH_BAR, (n, dist)
            if 2 * n == len(path1[1]):
                assert c == c1
                continue
            assert abs(f - f1) <= bar_f, (c, c1, f, f1, bar_f)
            assert abs(c - c1) <= bar_c * amax, (c, c1, amax, bar_c)
        c, _, f, _, amax = g[0][:5]
        assert abs(want[0][2] - f) <= bar_f and amax == want[0][4]
        assert abs(c - want[0][0]) <= bar_c * amax


def test_uneven_experts_and_vocab_serve(z3, one):
    """Reduced qwen2-moe-a2.7b with 4 experts and its vocabulary of 512
    over 3 model ranks (2, 2 and 0 experts; 171, 171 and 170 rows): the
    prefill statistics bit for bit, the logits within 1e-5 relative L2,
    the greedy tokens identical; the empty rank holds no expert."""
    want = one["uneven_serve"]
    for r in range(3):
        got = z3[r]["uneven_serve"]
        bad = []
        tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                           else bad.append(p), got["stats"], want["stats"])
        assert not bad, bad[:5]
        for a, b in zip(got["logits"], want["logits"]):
            assert _rel_l2(a, b) <= 1e-5
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)
        shapes = z3[r]["uneven_shapes"]
        assert shapes["decoder.layers.0.moe.w_up"][0] == [2, 2, 0][r]
        assert shapes["embed"][0] == [171, 171, 170][r]


def test_uneven_experts_and_vocab_train(z3, one):
    """The same model's train step on (1, 3): activation leaves bit for
    bit, gradient leaves within 1e-5, the loss within 1e-5 relative, the
    gradients (joined over the uneven shares) within 2**-7 relative L2."""
    want = one["uneven_train"]
    like = dict(model.init_params(_uneven_cfg(), seed=0,
                                  device="cpu").named_parameters())
    for r in range(3):
        got = z3[r]["uneven_train"]
        assert _quant_close(got["quant"], want["quant"], exact=False) > 0
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    whole = sharding.gather_named([z3[r]["uneven_train"]["grads"]
                                   for r in range(3)], like)
    for k, g in want["grads"].items():
        assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))


# ---------------------------------------------------------------------------
# From shapes alone.
# ---------------------------------------------------------------------------
_SHAPES = {}


def _leaf_shapes(name: str) -> dict:
    """``{dotted name: shape}`` of a config's parameters, one layer of
    each kind (the others repeat its shapes), from fake tensors."""
    if name not in _SHAPES:
        from torch._subclasses.fake_tensor import FakeTensorMode
        cfg = configs.get(name)
        with FakeTensorMode():
            p = model.init_params(dataclasses.replace(
                cfg, n_layers=min(cfg.n_layers, len(cfg.pattern)),
                **({"enc_layers": 1} if cfg.family == "encdec" else {})),
                device="cpu")
        _SHAPES[name] = {k: tuple(t.shape) for k, t in p.named_parameters()}
    return _SHAPES[name]


def _covered_once(boxes: list, shape: tuple) -> bool:
    """Whether the distinct non-empty boxes partition the leaf (on the
    grid their boundaries cut)."""
    uniq = {tuple(b) for b in boxes if all(n for _, n in b)}
    cuts = [sorted({0, n} | {lo for b in uniq for lo, _ in [b[d]]}
                   | {lo + c for b in uniq for lo, c in [b[d]]})
            for d, n in enumerate(shape)]
    count = np.zeros([len(c) - 1 for c in cuts], dtype=np.int64)
    for b in uniq:
        idx = tuple(slice(cuts[d].index(lo), cuts[d].index(lo + c))
                    for d, (lo, c) in enumerate(b))
        count[idx] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("name", sorted(configs.names()))
def test_stored_layout_from_shapes(name):
    """Every leaf of the config at (16, 16) and (2, 2), by the entries
    the reference's ``param_pspecs`` rule keeps at that mesh: a
    ``("data", "model")`` entry stores ``1 / (D M)`` of the leaf; else a
    rank stores its compute shard (the model axis's cut, ``split_range``'s
    share where it is uneven) over ``D`` where a ``"data"`` entry is
    kept, over ``M`` where only a ``"model"`` entry is and the leaf is
    whole for compute, whole otherwise; and the ranks' shares cover the
    leaf once."""
    from repro.runtime import sharding as jsh
    for D, M in ((16, 16), (2, 2)):
        sizes = {"data": D, "model": M}
        for k, shape in _leaf_shapes(name).items():
            path = tuple(k.split("."))
            spec = jsh._pad_spec(jsh._param_rule("/".join(path), path[-1],
                                                 shape), shape, sizes)
            axes = [ax if isinstance(ax, tuple) else (ax,) for ax in spec]
            numel = int(np.prod(shape))
            boxes = []
            for d in range(D):
                for m in range(M):
                    lay = sharding.layout_of(path, shape,
                                             {"data": d, "model": m}, sizes)
                    box = sharding.stored_box(lay)
                    boxes.append(box)
                    got = int(np.prod([n for _, n in box]))
                    cd = lay.model_dim
                    if ("data", "model") in axes:   # the grid
                        want = numel // (D * M)
                    else:       # the compute shard, then its storage
                        want = numel if cd is None else numel // shape[
                            cd] * sharding.split_range(shape[cd], M, m)[1]
                        if ("data",) in axes:
                            want //= D
                        elif ("model",) in axes and cd is None:
                            want //= M
                    assert got == want, (k, D, M, d, m, spec, got, want)
            assert _covered_once(boxes, shape), (k, D, M)


@pytest.mark.parametrize("msize", [2, 4, 8, 16])
def test_compute_dim_defined_for_every_config(msize):
    """The model axis's cut is defined for the ten configs at model 2, 4,
    8 and 16: qwen2-moe-a2.7b's 60 experts and seamless-m4t-medium's
    vocabulary (256206) take ``split_range``'s shares where they do not
    divide."""
    uneven = set()
    for name in configs.names():
        for k, shape in _leaf_shapes(name).items():
            path = tuple(k.split("."))
            d = sharding.compute_dim(path, shape, msize)
            if d is not None and shape[d] % msize:
                uneven.add((name, path[-1]))
    if msize >= 8:
        assert ("qwen2-moe-a2.7b", "w_up") in uneven
    if msize >= 4:
        assert ("seamless-m4t-medium", "embed") in uneven
        assert ("seamless-m4t-medium", "head") in uneven
    assert [sharding.split_range(60, 16, r)[1] for r in range(16)] == \
        [4] * 15 + [0]
    assert [sharding.split_range(256206, 8, r)[1] for r in range(8)] == \
        [32026] * 7 + [32024]
