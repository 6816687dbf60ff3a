"""The ``pod`` mesh axis: a stored train step on ``(pod 2, data 2, model
1)`` over 4 gloo ranks on the CPU against the one-process step.

The reference's multi-pod mesh splits the batch over ``("pod", "data")``
and stores the parameters over ``"data"`` (and ``"model"``) only, so each
pod holds a whole ZeRO-3 copy: a gradient share is reduce-scattered
within the pod and summed over the pods (``launch.mesh.mesh_groups(...,
pod=)``, ``runtime.steps.make_train_step(storage_group=, pod_group=)``).
Reduced starcoder2-3b, one AdamW step from seed 0, batch 4 (one row a
rank), held to ``tests/test_torch_zero3.py``'s bars for its ``(2, 1)``
step: the quant state bit for bit, the loss within 1e-5 relative, the
global norm within 2**-7 relative and each leaf's clipped gradient within
2**-7 of its largest element (the ranks' shares joined), the parameters
within 2 lr.  A rank stores exactly the data share a ``(2, 1)`` rank
stores, and both pods the same shares.  ``pod = 1`` gives the groups a
``(data, model)`` mesh always had.
"""
import pytest
import torch

from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map_with_path
from repro_torch.launch import mesh
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding, steps

B, S, LR = 4, 32, 1e-3
ARCH = "starcoder2-3b"
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


def _train(groups=None):
    cfg = configs.get_reduced(ARCH)
    opt = _Spy(adamw())
    st = steps.init_train_state(cfg, opt, POLICY, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        st = sharding.store_state(st, groups.coords, groups.sizes)
        kw = dict(group=groups.batch, model_group=groups.model,
                  storage_group=groups.data, pod_group=groups.pod)
    ts = steps.make_train_step(cfg, POLICY, opt, constant(LR), **kw)
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "norm": float(met["grad_norm"]), "grads": opt.grads,
            "state": st}


def _members(g) -> list:
    import torch.distributed as dist
    return None if g is None else dist.get_process_group_ranks(g)


def _ranks(rank, world, out_dir):
    torch.set_num_threads(1)
    one = mesh.mesh_groups(2, 2)
    explicit = mesh.mesh_groups(2, 2, pod=1)
    g = mesh.mesh_groups(2, 1, pod=2)
    res = {"groups": {
        "one_pod": [_members(x) for x in (one.data, one.model, one.batch,
                                          one.pod)] + [one.coords,
                                                       one.sizes],
        "explicit": [_members(x) for x in (explicit.data, explicit.model,
                                           explicit.batch, explicit.pod)],
        "pods": [_members(x) for x in (g.data, g.model, g.batch, g.pod)]
        + [g.coords, g.sizes]}}
    res["train"] = _train(g)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod")
    mesh.spawn_ranks(_ranks, 4, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def one():
    return _train()


def test_mesh_groups_pod_order(pods):
    """``rank = (p * data + d) * model + m``: on ``(2, 2, 1)`` rank r is
    pod r // 2, data r % 2; its data group is its pod's ranks, its batch
    group every rank, its pod group the ranks of its data coordinate."""
    for r, res in enumerate(pods):
        data_g, model_g, batch_g, pod_g, coords, sizes = \
            res["groups"]["pods"]
        assert coords == {"pod": r // 2, "data": r % 2, "model": 0}
        assert sizes == {"pod": 2, "data": 2, "model": 1}
        assert data_g == [2 * (r // 2), 2 * (r // 2) + 1]
        assert model_g == [r]
        assert batch_g == [0, 1, 2, 3]
        assert pod_g == [r % 2, r % 2 + 2]


def test_one_pod_is_todays_mesh(pods):
    """``pod = 1`` (the default) gives the ``(data, model)`` mesh's
    groups: data group the ranks of a model coordinate, model group those
    of a data coordinate, the batch group the data group, no pod group,
    and no ``"pod"`` coordinate."""
    for r, res in enumerate(pods):
        data_g, model_g, batch_g, pod_g, coords, sizes = \
            res["groups"]["one_pod"]
        d, m = divmod(r, 2)
        assert coords == {"data": d, "model": m}
        assert sizes == {"data": 2, "model": 2}
        assert data_g == [m, m + 2] and model_g == [2 * d, 2 * d + 1]
        assert batch_g == data_g and pod_g is None
        assert res["groups"]["explicit"] == [data_g, model_g, batch_g, None]


def test_pod_step_matches_one_process(pods, one):
    """The stored ``(2, 2, 1)`` step against the one-process step (module
    docstring's bars); both pods end on the same shares."""
    bad = []

    def cmp(path, a, b):
        if not torch.equal(a, b):
            bad.append(path)
    for r in pods:
        got = r["train"]
        tree_map_with_path(cmp, got["quant"], one["quant"])
        assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert abs(got["norm"] - one["norm"]) <= 2 ** -7 * one["norm"]
    assert not bad, bad[:5]
    for pod in (0, 1):
        ranks = pods[2 * pod:2 * pod + 2]
        named = [dict(r["train"]["state"]["params"].named_parameters())
                 for r in ranks]
        lays = {k: [sharding.stored_of(n[k]) for n in named]
                for k in named[0]}
        for k, g in one["grads"].items():
            whole = sharding._whole_of([r["train"]["grads"][k]
                                        for r in ranks], lays[k])
            d = float((whole - g).abs().max())
            assert d <= 2 ** -7 * float(g.abs().max()), (pod, k, d)
        params = dict(sharding.gather_state(
            [r["train"]["state"] for r in ranks])["params"]
            .named_parameters())
        for k, p in one["state"]["params"].named_parameters():
            d = float((params[k] - p).detach().abs().max())
            assert d <= 2 * LR * 1.001, (pod, k, d)
    for a, b in zip(pods[0:2], pods[2:4]):      # the pods' copies agree
        for k, p in a["train"]["state"]["params"].named_parameters():
            q = dict(b["train"]["state"]["params"].named_parameters())[k]
            assert torch.equal(p, q), k


def test_pod_rank_stores_a_data_share(pods):
    """A ``(2, 2, 1)`` rank's parameters and AdamW moments are exactly
    the shares a ``(2, 1)`` rank of its data coordinate stores."""
    cfg = configs.get_reduced(ARCH)
    whole = steps.init_train_state(cfg, adamw(), POLICY, seed=0,
                                   device="cpu")
    for r, res in enumerate(pods):
        want = sharding.store_state(whole, {"data": r % 2, "model": 0},
                                    {"data": 2, "model": 1})
        got = res["train"]["state"]
        wn = dict(want["params"].named_parameters())
        split = 0
        for k, p in got["params"].named_parameters():
            assert p.shape == wn[k].shape, k
            assert sharding.stored_of(p) == sharding.stored_of(wn[k]), k
            for m in ("m", "v"):
                assert got["opt"][m][k].shape == want["opt"][m][k].shape
            split += "data" in sharding.stored_of(p).axes
        assert split > 0
