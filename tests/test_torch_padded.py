"""Padded head sharding (the reference's third attention layout) and the
length-sharded decode cache on the ``model`` axis, on the CPU.

One module fixture spawns 4 gloo ranks once (``launch.mesh.spawn_ranks``,
a FileStore under a temporary directory), a ``(1, 4)`` mesh, on reduced
configs whose heads do not split evenly over 4 (``dataclasses.replace``):

* ``g5``: reduced starcoder2-3b with KV 1, G 5 (``"g_pad"``: the ranks
  hold 2, 2, 1 and 0 heads), its sliding window 16: a 24-token prefill
  on the int8 core into a ring of 16 slots (4 a rank), decode past the
  window; one 1 x 32 train step on the sliding int8 core past the
  window;
* ``nemo``: reduced nemotron-4-340b (KV 2, G 3: 1, 1, 1 and 0 heads)
  with an int8 cache of 19 slots, which 4 does not divide (whole on every
  rank); one train step on ``_chunked_attn`` (``dense_attn_max`` 16, the
  ``current`` estimators on the simulated backend, fp32 activations:
  in bf16 one process adds each q chunk's k / v cotangent in bf16, as
  the reference does, so a rank's share added in another order moves
  the ``current`` gradient ranges by bf16 ulps, past the bounds below);
* ``kv3``: KV 3, G 1 (``"kv_pad"``: 1, 1, 1 and 0 KV heads, k and v
  sliced to them) with a causal cache of 20 slots (5 a rank);
* ``s6``: reduced seamless-m4t-medium with KV 2, G 3: the decoder's
  self-attention cache and the cross ``xkv`` cache of 20 slots each (5 a
  rank; the 16 frames fill rank 3's first slot only), cross decode over
  the length shard; the encoder runs the sequence-parallel core.

Each rank saves what it got; the tests hold it against the port's
one-process program (which the other tests hold against the reference):

* prefill: the statistics bit for bit; at width 10 (telemetry) every
  site's (min, max, visited) and each core p-site's (clip, n) exact, its
  err/sig within 1e-4 (a head's sums added on another rank); each rank's
  cache its slice of the one-process cache by the reference's
  ``repro.runtime.sharding.cache_pspecs``, bit for bit; the logits within
  1e-5 relative L2;
* decode: the greedy tokens identical and each step's logits within 1e-5
  relative L2 (the decode's fp32 sums over L are split over the ranks,
  the vocab-parallel head's products run per shard);
* train: ``tests/test_torch_tp.py``'s bounds (activation leaves bit for
  bit, gradient leaves within 1e-5 of their largest element, the loss
  within 1e-5 relative, the gradients within 2**-7 relative L2).

Structural checks without ranks: ``split_range``'s shares, every cache
kind's shapes on every rank against the reference's ``cache_pspecs``,
``shard_params`` -> ``gather_params`` on the uneven split and
``shard_noise`` as the global noise's uneven slice.

This module imports JAX only inside the tests that read the reference:
the rank processes import it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map_with_path
from repro_torch.launch import mesh
from repro_torch.models import attention, model
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding, steps
from repro_torch.telemetry.config import T_CLIP, T_N, T_UTIL

POLICY = QuantPolicy.w8a8g8(backend="fused")
MSIZE, B, LR = 4, 4, 1e-3
# The decode's bar: this many times its one-process floor (its distance
# from itself with the sums over L reassociated), the floor at most the cap
FLOOR_MARGIN, FLOOR_CAP = 4.0, 5e-2


def _cfg(case: str):
    if case == "g5":
        return dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                                   n_heads=5, n_kv=1)
    if case == "kv3":
        return dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                                   n_heads=3, n_kv=3, sliding_window=None)
    if case == "s6":
        return dataclasses.replace(
            configs.get_reduced("seamless-m4t-medium"), n_heads=6, n_kv=2)
    if case == "nemo":
        return dataclasses.replace(configs.get_reduced("nemotron-4-340b"),
                                   cache_dtype="int8")
    if case == "nemo-chunked":
        return dataclasses.replace(configs.get_reduced("nemotron-4-340b"),
                                   dense_attn_max=16, compute_dtype="float32")
    raise KeyError(case)


# case: (prompt length, decode steps); the cache holds both
SERVE = {"g5": (24, 4), "nemo": (16, 3), "kv3": (16, 4), "s6": (16, 4)}
# case: (sequence, policy)
TRAIN = {"g5": (32, POLICY),
         "nemo-chunked": (32, QuantPolicy.w8a8g8("current", "current",
                                                 backend="simulated"))}
SHARES = {"g5": [2, 2, 1, 0], "nemo": [1, 1, 1, 0], "kv3": [1, 1, 1, 0],
          "s6": [1, 1, 1, 0]}


def _serve(case, groups=None):
    """Prefill (statistics returned, width 3 and width 10) and greedy
    decode."""
    cfg = _cfg(case)
    s, gen = SERVE[case]
    params = model.init_params(cfg, seed=0, device="cpu")
    mg = None
    if groups is not None:
        params = sharding.shard_params(params, groups.coords, groups.sizes)
        mg = groups.model
    batch = data.for_arch(cfg, seq_len=s, global_batch=B, seed=1).batch(0)
    prompt = {k: v for k, v in batch.items() if k in ("tokens", "frames")}
    tele = POLICY.with_telemetry(enabled=True)
    out = {"tele": steps.make_prefill_step(
        cfg, tele, cache_len=s + gen, model_group=mg, return_stats=True)(
        params, model.init_quant_state(cfg, tele, device="cpu"), prompt)[2]}
    quant = model.init_quant_state(cfg, POLICY, device="cpu")
    logits, caches, stats = steps.make_prefill_step(
        cfg, POLICY, cache_len=s + gen, model_group=mg,
        return_stats=True)(params, quant, prompt)
    decode = steps.make_decode_step(cfg, POLICY, model_group=mg)
    out.update(logits=[logits], stats=stats, tokens=[],
               cache=tree_map_with_path(lambda p, t: t.clone(),
                                        caches["decoder"]))
    for i in range(gen):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        pos = torch.full((B,), s + i, dtype=torch.long)
        logits, caches = decode(params, quant, {"token": tok[:, None],
                                                "pos": pos}, caches)
        out["logits"].append(logits)
    return out


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


def _train(case, groups=None):
    cfg = _cfg(case)
    s, pol = TRAIN[case]
    opt = _Spy(adamw())
    st = steps.init_train_state(cfg, opt, pol, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        params = sharding.shard_params(st["params"], groups.coords,
                                       groups.sizes)
        st = steps.train_state(params, st["quant"], opt)
        kw = dict(group=groups.data, model_group=groups.model)
    ts = steps.make_train_step(cfg, pol, opt, constant(LR), **kw)
    batch = data.for_arch(cfg, seq_len=s, global_batch=1, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "grads": opt.grads}


def _ranks(rank, world, out_dir):
    g = mesh.mesh_groups(1, MSIZE)
    res = {"coords": g.coords, "heads": {}}
    layouts, layout_of = [], sharding.attn_layout

    def spy(*a, **kw):
        layouts.append(layout_of(*a, **kw))
        return layouts[-1]
    sharding.attn_layout = spy
    try:
        for case in SERVE:
            cfg = _cfg(case)
            with sharding.model_parallel(g.model):
                res["heads"][case] = attention.local_heads(
                    cfg.n_kv, cfg.n_heads // cfg.n_kv)
            res[f"serve/{case}"] = _serve(case, g)
        for case in TRAIN:
            res[f"train/{case}"] = _train(case, g)
    finally:
        sharding.attn_layout = layout_of
    res["layouts"] = sorted(set(layouts))
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def padded(tmp_path_factory):
    d = tmp_path_factory.mktemp("padded")
    mesh.spawn_ranks(_ranks, MSIZE, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(MSIZE)]


@pytest.fixture(scope="module")
def one():
    from repro_torch.core import backend
    with backend.reassociate(MSIZE):       # the decode's floor
        floor = {f"floor/{c}": _serve(c) for c in SERVE}
    return {**{f"serve/{c}": _serve(c) for c in SERVE},
            **{f"train/{c}": _train(c) for c in TRAIN}, **floor}


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def _ref_cache_specs(cache) -> dict:
    """``{path: spec}`` of the reference's ``cache_pspecs`` applied to the
    port's one-process cache tree on a ``(1, MSIZE)`` mesh."""
    import jax
    from repro.runtime import sharding as jsh
    specs = jsh.cache_pspecs(cache, types.SimpleNamespace(
        shape={"data": 1, "model": MSIZE}), ("data",))
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, tuple)):
        out[tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path)] = tuple(spec)
    return out


def _rank_slice(t, spec, m):
    """Model rank ``m``'s slice of a whole cache leaf by ``spec``."""
    for d, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[d] // MSIZE
            t = t.narrow(d, m * n, n)
    return t


def _flat(tree) -> dict:
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(tuple(map(str, p)), t),
                       tree)
    return out


def test_split_range_shares():
    """A padded dim's shares: ``[r c, min((r + 1) c, n))``, ``c = ceil(n /
    M)``; the even split where M divides n."""
    def shares(n, m):
        return [sharding.split_range(n, m, r)[1] for r in range(m)]
    assert shares(12, 8) == [2, 2, 2, 2, 2, 2, 0, 0]
    assert shares(9, 8) == [2, 2, 2, 2, 1, 0, 0, 0]
    assert shares(12, 16) == [1] * 12 + [0] * 4
    assert shares(5, 4) == [2, 2, 1, 0]
    for n, m in ((16, 4), (24, 8), (6, 3)):
        assert [sharding.split_range(n, m, r) for r in range(m)] == \
            [(r * n // m, n // m) for r in range(m)]
    for n in range(1, 20):
        for m in range(1, 9):
            lo = [sharding.split_range(n, m, r) for r in range(m)]
            assert sum(c for _, c in lo) == n
            assert all(a + c <= b or c == 0
                       for (a, c), (b, _) in zip(lo, lo[1:]))


@pytest.mark.parametrize("length", [1, 5, 16, 20, 33])
def test_owned_positions_are_the_mask(length):
    """A length shard's prefill positions (``attention._owned_positions``,
    at most two ranges) are exactly those whose slot a mask over its
    share selects, in order, for prompts shorter and longer than the
    ring and every share of 1-8 ranks."""
    from repro_torch.models import attention
    for s in range(1, 3 * length + 2):
        start = max(0, s - length)
        slots = torch.arange(start, s) % length
        for m in range(1, 9):
            for r in range(m):
                lo, n = sharding.split_range(length, m, r)
                want = torch.nonzero((slots >= lo) & (slots < lo + n))[:, 0]
                got = attention._owned_positions(start, s, length, lo, n,
                                                 "cpu")
                assert got.dtype == torch.long
                assert torch.equal(got, want), (s, m, r)


@pytest.mark.parametrize("case", list(SERVE))
def test_padded_layout_and_head_shares(padded, case):
    """Every rank ran the padded layouts (the encoder the sequence core,
    the exact layouts nowhere), and held ``split_range``'s share of the
    padded head dim."""
    cfg = _cfg(case)
    kv, g = cfg.n_kv, cfg.n_heads // cfg.n_kv
    want = sharding.choose_head_axis(kv, g, MSIZE) + "_pad"
    for r in range(MSIZE):
        assert padded[r]["layouts"] == ["g_pad", "kv_pad", "seq"], \
            padded[r]["layouts"]
        got = padded[r]["heads"][case]
        assert got[2] == want
        share = got[0] if want == "kv_pad" else got[1]
        assert share == SHARES[case][r], (case, r, got)


@pytest.mark.parametrize("case", list(SERVE))
def test_padded_prefill_matches_one_process(padded, one, case):
    """A W8A8G8 prefill into a cache on padded heads: statistics bit for
    bit; at width 10 (min, max, visited) everywhere and each p-site's
    (clip, n) exact, err/sig within 1e-4; each rank's cache the
    reference ``cache_pspecs`` slice of the one-process cache; logits
    within 1e-5 relative L2."""
    want = one[f"serve/{case}"]
    specs = _ref_cache_specs(want["cache"])
    whole = _flat(want["cache"])
    n_p = [0]
    for r in range(MSIZE):
        got = padded[r][f"serve/{case}"]
        bad = []
        tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                           else bad.append(p), got["stats"], want["stats"])
        assert not bad, bad[:5]

        def tele(path, a, b):
            assert torch.equal(a[:3], b[:3]), path
            if path[-3:-1] == ("core", "p") and b[2] > 0.5:
                n_p[0] += 1
                assert torch.equal(a[T_CLIP:T_N + 1], b[T_CLIP:T_N + 1]), path
                np.testing.assert_allclose(a[T_N + 1:T_UTIL].numpy(),
                                           b[T_N + 1:T_UTIL].numpy(),
                                           rtol=1e-4, atol=1e-7)
        tree_map_with_path(tele, got["tele"], want["tele"])
        have = _flat(got["cache"])
        assert sorted(have) == sorted(whole)
        for path, t in whole.items():
            part = _rank_slice(t, specs[path], r)
            assert have[path].shape == part.shape, (path, have[path].shape)
            assert torch.equal(have[path], part), path
        assert _rel_l2(got["logits"][0], want["logits"][0]) <= 1e-5
    n_want = []
    tree_map_with_path(lambda p, b: n_want.append(p) if p[-3:-1] == (
        "core", "p") and b[2] > 0.5 else None, want["tele"])
    assert len(n_want) >= _cfg(case).n_layers
    assert n_p[0] == MSIZE * len(n_want)


@pytest.mark.parametrize("case", list(SERVE))
def test_padded_decode_matches_one_process(padded, one, case):
    """Greedy decode on padded heads against a length-sharded ring past
    its window (``g5``), a whole int8 cache (``nemo``), a length-sharded
    causal cache under ``"kv_pad"`` (``kv3``) and length-sharded self and
    cross caches (``s6``): the tokens identical, every step's logits
    within the larger of 1e-5 and ``FLOOR_MARGIN`` times the one-process
    decode's distance from itself with its sums over L in ``MSIZE``
    blocks (``backend.reassociate``, phase 48's floor), which must stay
    below ``FLOOR_CAP``; and within 1e-5 of that reassociated decode
    where the cache is length-sharded (its blocks are the ranks' slots),
    of the plain one where it is whole."""
    want = one[f"serve/{case}"]
    floor = max(_rel_l2(a, b) for a, b in zip(
        one[f"floor/{case}"]["logits"][1:], want["logits"][1:]))
    assert floor <= FLOOR_CAP
    bar = max(1e-5, FLOOR_MARGIN * floor)
    splits = {"g5": 1, "nemo": None, "kv3": 1, "s6": 1}[case]
    spec = _ref_cache_specs(want["cache"])[("layers", "0", "kv", "k")]
    assert spec[1] == ("model" if splits == 1 else None), spec
    if case == "s6":
        xspec = _ref_cache_specs(want["cache"])[("layers", "0", "xkv", "k")]
        assert xspec[1] == "model", xspec
    for r in range(MSIZE):
        got = padded[r][f"serve/{case}"]
        assert len(got["logits"]) == SERVE[case][1] + 1
        assert _rel_l2(got["logits"][0], want["logits"][0]) <= 1e-5
        same = one[f"floor/{case}"] if splits == 1 else want
        for a, b, c in zip(got["logits"][1:], want["logits"][1:],
                           same["logits"][1:]):
            assert _rel_l2(a, b) <= bar, (r, _rel_l2(a, b), floor)
            assert _rel_l2(a, c) <= 1e-5
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(TRAIN))
def test_padded_train_step_matches_one_process(padded, one, case):
    """One train step on padded heads (the sliding int8 core past the
    window; ``_chunked_attn``): ``tests/test_torch_tp.py``'s bounds."""
    want = one[f"train/{case}"]
    like = dict(model.init_params(_cfg(case), seed=0,
                                  device="cpu").named_parameters())
    for r in range(MSIZE):
        got = padded[r][f"train/{case}"]
        bad, n = [], []

        def cmp(path, a, b):
            if "grad" in path:
                n.append(path)
                if float((a - b).abs().max()) > 1e-5 * float(b.abs().max()):
                    bad.append(path)
            elif not torch.equal(a, b):
                bad.append(path)
        tree_map_with_path(cmp, got["quant"], want["quant"])
        assert not bad and n, bad[:5]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    whole = sharding.gather_named([padded[r][f"train/{case}"]["grads"]
                                   for r in range(MSIZE)], like)
    for k, g in want["grads"].items():
        assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))
    assert padded[MSIZE - 1][f"train/{case}"]["grads"][
        "decoder.layers.0.attn.wq"].shape[2] == 0


CACHE_ARCHS = ("starcoder2-3b", "recurrentgemma-9b", "rwkv6-7b",
               "seamless-m4t-medium", "qwen2-moe-a2.7b", "g5", "kv3",
               "nemo")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shapes_are_the_reference_cache_pspecs(monkeypatch, arch):
    """Every rank's decode cache (attn, local, moe, xattn with its xkv,
    rec, rwkv) at a length 4 divides and one it does not: each leaf's
    shape is the reference ``cache_pspecs`` spec applied to the
    one-process cache, and the slices it records are those dims."""
    cfg = _cfg(arch) if arch in ("g5", "kv3", "nemo") else \
        configs.get_reduced(arch)
    for length in (32, 30):
        whole = model.init_cache(cfg, B, length, "cpu")
        specs = _ref_cache_specs(whole["decoder"])
        flat = _flat(whole["decoder"])
        for r in range(MSIZE):
            monkeypatch.setattr(sharding, "_MP", (None, r, MSIZE))
            part = _flat(model.init_cache(cfg, B, length, "cpu")["decoder"])
            monkeypatch.setattr(sharding, "_MP", None)
            assert sorted(part) == sorted(flat)
            for path, t in part.items():
                spec = specs[path]
                assert t.shape == _rank_slice(flat[path], spec, r).shape, \
                    (arch, length, path, spec, t.shape)
                split = sharding.cache_split_of(t)
                if path[-1] in ("k", "v", "pos"):
                    dims = [d for d, ax in enumerate(spec) if ax == "model"]
                    assert (split[0] if split else None) == \
                        (dims[0] if dims else None), (path, spec, split)


@pytest.mark.parametrize("case", ["g5", "nemo", "kv3"])
def test_shard_and_gather_params_round_trip_uneven(case):
    """``shard_params`` at model 4 and 8 then ``gather_params`` gives the
    tree back; ``wq`` / ``wo`` / ``bq`` hold ``split_range``'s shares of
    the padded dim, ``wk`` / ``wv`` stay whole."""
    cfg = dataclasses.replace(_cfg(case), use_bias=True)
    full = model.init_params(cfg, seed=0, device="cpu")
    kv, g = cfg.n_kv, cfg.n_heads // cfg.n_kv
    for msize in (4, 8):
        axis = sharding.choose_head_axis(kv, g, msize)
        n = kv if axis == "kv" else g
        shards = [sharding.shard_params(full, {"model": m},
                                        {"model": msize})
                  for m in range(msize)]
        back = sharding.gather_params(shards, full)
        for (k, a), b in zip(full.named_parameters(), back.parameters()):
            assert torch.equal(a, b), k
        for m, sh in enumerate(shards):
            p = dict(sh.named_parameters())
            lo, cnt = sharding.split_range(n, msize, m)
            for name, base in (("wq", 1), ("wo", 0), ("bq", 0)):
                t = p[f"decoder.layers.0.attn.{name}"]
                d = base + (0 if axis == "kv" else 1)
                assert sharding.model_dim_of(t) == d
                want = dict(full.named_parameters())[
                    f"decoder.layers.0.attn.{name}"].narrow(d, lo, cnt)
                assert torch.equal(t, want), (name, m)
            for name in ("wk", "wv", "bk", "bv"):
                assert sharding.model_dim_of(
                    p[f"decoder.layers.0.attn.{name}"]) is None


def test_shard_noise_is_the_global_noise_uneven_slice(monkeypatch):
    """A gradient site on a padded head dim (``(dim, whole size)``) draws
    the global site's noise and keeps this rank's share, an empty one
    included; with data parallelism too."""
    from repro_torch.core import backend
    full = backend.site_noise(11, (4, 6, 5, 8), "cpu")
    for m, (lo, n) in enumerate(sharding.split_range(5, 4, r)
                                for r in range(4)):
        monkeypatch.setattr(sharding, "_MP", (None, m, 4))
        got = backend.shard_noise(11, (4, 6, n, 8), "cpu",
                                  model_dim=(2, 5))
        assert got.shape == (4, 6, n, 8)
        assert torch.equal(got, full[:, :, lo:lo + n])
        monkeypatch.setattr(sharding, "_DP", (None, 1, 2))
        got = backend.shard_noise(11, (2, 6, n, 8), "cpu", 0, (2, 5))
        assert torch.equal(got, full[2:, :, lo:lo + n])
        monkeypatch.setattr(sharding, "_DP", None)


@pytest.mark.parametrize("spec, xshape, wshape", [
    ("bskgh,kghd->bsd", (2, 5, 2, 3, 16), (2, 3, 16, 24)),
    ("bsn,nk->bsk", (2, 7, 40), (40, 24))])
def test_reassociate_splits_the_dx_products(spec, xshape, wshape):
    """``backend.reassociate`` (a floor measurement's model-axis
    association): the backward's dx product runs its contraction in
    blocks, summed in order, within fp32 rounding of the one product;
    outside it, the one product itself."""
    from repro_torch.core import backend
    gen = torch.Generator().manual_seed(len(xshape))
    x_img = torch.randint(0, 256, xshape, generator=gen).to(torch.uint8)
    w_img = torch.randint(-127, 128, wshape, generator=gen).to(torch.int8)
    wq = w_img.float() * 0.01
    lhs, out = spec.split("->")
    xs, ws = lhs.split(",")
    g = torch.randn([dict(zip(xs + ws, xshape + wshape))[c] for c in out],
                    generator=gen)

    def dx():
        xq = (x_img.float() - 3).requires_grad_()
        y = backend._QMatmulInt.apply(xq, wq, x_img, w_img,
                                      torch.tensor(3.0), torch.tensor(0.01),
                                      spec, False, 0, None)
        y.backward(g)
        return xq.grad

    want = torch.einsum(f"{out},{ws}->{xs}", g, wq)
    assert torch.equal(dx(), want)
    moved = False
    for blocks in (2, 3, 8):
        with backend.reassociate(blocks):
            got = dx()
        moved |= not torch.equal(got, want)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    assert moved                 # another association: other bits
    assert torch.equal(dx(), want)


@pytest.mark.parametrize("mode", ["causal", "sliding"])
def test_decode_attn_runs_in_fp32(mode):
    """One-process decode is the reference's fp32 softmax bit for bit;
    under ``backend.reassociate(8)`` (phase 48's floor) its sums over the
    cache length run in 8 blocks, within fp32 rounding of it."""
    from repro_torch.core import backend
    gen = torch.Generator().manual_seed(7)
    b, length, kv, g, hd = 2, 40, 2, 3, 16
    q = torch.randn((b, 1, kv, g, hd), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((b, length, kv, hd), generator=gen).to(
        torch.bfloat16) for _ in range(2))
    pos = torch.arange(length).repeat(b, 1).to(torch.int32)
    pos[1, 30:] = -1
    cur = torch.tensor([39, 29])
    kw = dict(mode=mode, window=24, prefix_len=0, scale=0.25)
    s = torch.einsum("bkgh,blkh->bkgl", q[:, 0].float() * 0.25, k.float())
    valid = (pos[:, None, None] >= 0) & (pos[:, None, None]
                                         <= cur[:, None, None, None])
    if mode == "sliding":
        valid &= (cur[:, None, None, None] - pos[:, None, None]) < 24
    s = torch.where(valid, s, attention.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    want = (torch.einsum("bkgl,blkh->bkgh", p, v.float())
            / p.sum(dim=-1).clamp(min=1e-30)[..., None])[:, None].to(q.dtype)
    got = attention._decode_attn(q, k, v, pos, cur, **kw)
    assert torch.equal(got, want)
    with backend.reassociate(8):
        got = attention._decode_attn(q, k, v, pos, cur, **kw)
    assert _rel_l2(got, want) <= 1e-2      # bf16 outputs: an ulp at most
    assert float((got.float() - want.float()).abs().max()) <= 2 ** -7 * \
        float(want.float().abs().max())


def test_empty_operands_give_neutral_statistics():
    """On CPU tensors too: an empty share's quantize, int32 partial,
    product and attention core return empty or zero outputs and neutral
    ``(+inf, -inf)`` statistics (the plain versions run nothing), and the
    core's p-site partials reduce to the neutral vector."""
    from repro_torch.core.quant import QuantSpec, tensor_minmax
    from repro_torch.kernels import int8_attention as tattn
    from repro_torch.kernels import ops
    inf = float("inf")
    x = torch.empty((4, 8, 2, 0, 16))
    assert [float(t) for t in tensor_minmax(x)] == [inf, -inf]
    q, mn, mx = ops.fused_quantize(x, torch.tensor(-1.0), torch.tensor(1.0),
                                   spec=QuantSpec(bits=8, symmetric=False))
    assert q.shape == x.shape and (float(mn), float(mx)) == (inf, -inf)
    xi = torch.empty((4, 8, 2, 0, 16), dtype=torch.uint8)
    acc = ops.int8_matmul_int32(xi, torch.empty((2, 0, 16, 32),
                                                dtype=torch.int8),
                                3.0, plan=ops.plan_einsum(
                                    "bskgh,kghd->bsd", 5, 4))
    assert acc.shape == (4, 8, 32) and not acc.any()
    y, mn, _ = ops.int8_matmul_fp(
        torch.zeros((4, 8, 32), dtype=torch.uint8),
        torch.empty((32, 2, 0, 16), dtype=torch.int8), 3.0, 0.5,
        plan=ops.plan_einsum("bsd,dkgh->bskgh", 3, 4))
    assert y.shape == (4, 8, 2, 0, 16) and float(mn) == inf
    sched = tattn.make_schedule(sq=8, skv=8, hd=16, bq=8, bkv=8, groups=1,
                                mode="causal", sm_scale=0.25)
    k = torch.zeros((8, 8, 16), dtype=torch.int8)
    out, ml, ps = ops.int8_attention_fp(
        torch.empty((0, 8, 16), dtype=torch.uint8), k, k, torch.zeros(8),
        torch.tensor([8], dtype=torch.int32), sched=sched)
    assert out.shape == (0, 8, 16) and ml.shape == (0, 8, 2)
    assert [float(t) for t in tattn.reduce_pstats(ps)] == \
        [inf, -inf, 0.0, 0.0, 0.0, 0.0]
    dq, dk, dv = tattn.attention_core_backward(
        torch.empty((0, 8, 16)), k.float(), k.float(),
        torch.empty((0, 8, 16), dtype=torch.uint8), k, k, torch.zeros(8),
        torch.tensor([8], dtype=torch.int32), out, ml,
        torch.empty((0, 8, 16)), sched=sched)
    assert dq.shape == (0, 8, 16) and not dk.any() and not dv.any()
