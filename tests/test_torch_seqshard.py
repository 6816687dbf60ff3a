"""The remat unit and the sequence-parallel residual (``seq_shard``, the
reference's ``"seq": "model"`` mapping) on the CPU.

* The remat unit: reduced nemotron-4-340b cut to 9 layers (two units of
  its four ``attn`` blocks, one tail block) and reduced
  recurrentgemma-9b (5 layers: one ``(rec, rec, local)`` unit, two tail
  blocks).  ``transformer.checkpoint`` is called once a unit and runs
  exactly that unit's blocks; the tail runs outside any checkpoint.
  The loss, every gradient and the statistics of one forward + backward
  equal, bit for bit, those of per-block remat (each block its own
  checkpoint) and of no remat.
* ``seq_shard`` on ``(1, 4)`` (4 gloo ranks spawned once in a module
  fixture, one thread each) against one process, for the seven block
  kinds: reduced starcoder2-3b and command-r-35b (``attn``: the ``"seq"``
  core in training, padded heads in a cache-filling prefill),
  qwen2-moe-a2.7b (``moe``, KV heads), recurrentgemma-9b (``rec``,
  ``local``), rwkv6-7b (``rwkv``) and seamless-m4t-medium (``enc``,
  ``xattn``).  Every block's input is the rank's
  ``sharding.split_range`` rows of the sequence.  A prefill's statistics
  and logits and 3 greedy decode steps' logits bit for bit; one train
  step with ``tests/test_torch_tp.py``'s bars (activation leaves bit for
  bit, the loss within 1e-5 relative, gradients within 2**-7 relative
  L2, gradient leaves within 1e-5 of their largest element; where the
  model axis itself on 4 ranks is farther, recurrentgemma-9b, the quant
  state and loss equal the same mesh's step without ``seq_shard`` bit
  for bit and the gradients are within 2**-7 of its); a
  telemetry forward (width 10, every
  element sampled): (min, max, visited, clip, n) exact, err / sig
  within 1e-4.
* Uneven rows: starcoder2-3b at S 15 (rows 4 / 4 / 4 / 3) served and
  trained, and decode's S = 1 (ranks 1-3 hold no row): tokens identical,
  logits bit for bit.
* One anchor against the reference: reduced starcoder2-3b (fp32
  compute) converted from the JAX parameters, its ``seq_shard`` prefill
  against the JAX ``model.prefill`` on the ``simulated`` backend at
  ``tests/test_torch_serve.py``'s fp32 tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, convert, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map_with_path
from repro_torch.launch import mesh
from repro_torch.models import model, transformer
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding, steps
from repro_torch.telemetry.config import T_N, T_UTIL

POLICY = QuantPolicy.w8a8g8(backend="fused")
TELE = POLICY.with_telemetry(enabled=True, sample=0)
LR, B, S, GEN, MSIZE = 1e-3, 4, 32, 3, 4
ARCHS = ("starcoder2-3b", "command-r-35b", "qwen2-moe-a2.7b",
         "recurrentgemma-9b", "rwkv6-7b", "seamless-m4t-medium")
UNEVEN = ("starcoder2-3b", 15)
# the model axis's own distance from one process on 4 gloo ranks, with or
# without seq_shard: a gradient leaf 6.1e-5 of its largest element off
# (layer 0's mlp up), embed's gradient 1.1e-2 relative L2 (the fp32 sums
# of 4 partials in the collective's order, carried down the layers by
# the stochastic rounding)
TP_FLOOR = ("recurrentgemma-9b",)
ANCHOR, ANCHOR_S = "starcoder2-3b", 24


# ---------------------------------------------------------------------------
# The remat unit.
# ---------------------------------------------------------------------------
def _fwd_bwd(cfg, remat: bool):
    cfg = dataclasses.replace(cfg, remat=remat)
    params = model.init_params(cfg, seed=0, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    quant = model.init_quant_state(cfg, POLICY, device="cpu")
    batch = data.for_arch(cfg, seq_len=16, global_batch=2, seed=0).batch(0)
    loss, grads, stats, _ = steps.forward_backward(cfg, POLICY, params,
                                                   quant, batch, 0, 0)
    return loss, grads, stats


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    bad = []
    tree_map_with_path(lambda p, x, y: None if torch.equal(x, y)
                       else bad.append(p), a[2], b[2])
    assert not bad, bad[:5]


@pytest.mark.parametrize("arch, layers, units", [("nemotron-4-340b", 9, 2),
                                                 ("recurrentgemma-9b", 5, 1)])
def test_remat_checkpoints_pattern_units_and_leaves_the_tail(
        monkeypatch, arch, layers, units):
    cfg = dataclasses.replace(configs.get_reduced(arch), n_layers=layers)
    unit = len(cfg.pattern)
    orig_ckpt, orig_block = transformer.checkpoint, transformer._apply_block
    depth, calls, seen = [0], [], []

    def ckpt(fn, *a, **kw):
        depth[0] += 1
        calls.append(len(seen))
        try:
            return orig_ckpt(fn, *a, **kw)
        finally:
            depth[0] -= 1

    def block(kind, *a, seed, **kw):
        seen.append((seed // transformer._SEED_STRIDE, depth[0] > 0))
        return orig_block(kind, *a, seed=seed, **kw)
    monkeypatch.setattr(transformer, "checkpoint", ckpt)
    monkeypatch.setattr(transformer, "_apply_block", block)
    got = _fwd_bwd(cfg, True)
    fwd = seen[:layers]         # the forward; the recomputes follow
    assert calls == [u * unit for u in range(units)]
    assert fwd == [(i, i < units * unit) for i in range(layers)]
    monkeypatch.setattr(transformer, "checkpoint", orig_ckpt)

    def per_block(kind, params, sites, x, **kw):
        return orig_ckpt(functools.partial(orig_block, kind, params, sites,
                                           **kw), x, use_reentrant=False)
    monkeypatch.setattr(transformer, "_apply_block", per_block)
    _assert_same(got, _fwd_bwd(cfg, False))     # each block checkpointed
    monkeypatch.setattr(transformer, "_apply_block", orig_block)
    _assert_same(got, _fwd_bwd(cfg, False))     # no remat


# ---------------------------------------------------------------------------
# seq_shard on (1, 4).
# ---------------------------------------------------------------------------
class _Spy:
    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params, lr)


def _train(arch, s, groups=None, seq_shard=False):
    cfg = configs.get_reduced(arch)
    opt = _Spy(adamw())
    st = steps.init_train_state(cfg, opt, POLICY, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        params = sharding.shard_params(st["params"], groups.coords,
                                       groups.sizes)
        st = steps.train_state(params, st["quant"], opt)
        kw = dict(group=groups.data, model_group=groups.model,
                  seq_shard=seq_shard)
    ts = steps.make_train_step(cfg, POLICY, opt, constant(LR), **kw)
    batch = data.for_arch(cfg, seq_len=s, global_batch=B, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "grads": opt.grads}


def _serve(arch, s, groups=None, params=None, cfg=None):
    """Prefill (statistics returned) and GEN greedy decode steps."""
    cfg = cfg or configs.get_reduced(arch)
    if params is None:
        params = model.init_params(cfg, seed=0, device="cpu")
    kw = {}
    if groups is not None:
        params = sharding.shard_params(params, groups.coords, groups.sizes)
        kw = dict(model_group=groups.model, seq_shard=True)
    quant = model.init_quant_state(cfg, POLICY, device="cpu")
    batch = data.for_arch(cfg, seq_len=s, global_batch=B, seed=1).batch(0)
    prefill = steps.make_prefill_step(cfg, POLICY, cache_len=s + GEN,
                                      return_stats=True, **kw)
    decode = steps.make_decode_step(cfg, POLICY, **kw)
    logits, caches, stats = prefill(
        params, quant, {k: v for k, v in batch.items()
                        if k not in ("labels", "mask")})
    out = {"logits": [logits], "stats": stats, "tokens": []}
    for i in range(GEN):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        pos = torch.full((B,), s + i, dtype=torch.long)
        logits, caches = decode(params, quant, {"token": tok[:, None],
                                                "pos": pos}, caches)
        out["logits"].append(logits)
    return out


def _width10(arch, groups=None):
    """A telemetry forward's statistics (combined over the model
    group)."""
    cfg = configs.get_reduced(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    model_group = None
    if groups is not None:
        params = sharding.shard_params(params, groups.coords, groups.sizes)
        model_group = groups.model
    quant = model.init_quant_state(cfg, TELE, device="cpu")
    batch = data.for_arch(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    with torch.no_grad(), sharding.model_parallel(model_group), \
            sharding.sequence_parallel(True):
        _, (fwd, _) = model.loss_fn(params, quant, batch, cfg, TELE, 0, 0)
    if model_group is not None:
        fwd = steps.dp_combine_stats(fwd, model_group)
    return fwd


def _anchor_cfg():
    return dataclasses.replace(configs.get_reduced(ANCHOR),
                               compute_dtype="float32",
                               cache_dtype="float32")


def _ranks(rank, world, out_dir):
    torch.set_num_threads(1)
    g = mesh.mesh_groups(1, MSIZE)
    rows = []
    orig = transformer._apply_block

    def spy(kind, params, sites, x, *, seq_len=None, **kw):
        if sharding.seq_rows():
            rows.append((seq_len, x.shape[1]))
        return orig(kind, params, sites, x, seq_len=seq_len, **kw)
    transformer._apply_block = spy
    res = {}
    try:
        for arch in ARCHS:
            res[arch] = {"serve": _serve(arch, S, g),
                         "train": _train(arch, S, g, True),
                         "tele": _width10(arch, g)}
            if arch in TP_FLOOR:
                res[arch]["tp"] = _train(arch, S, g, False)
        arch, s = UNEVEN
        res["uneven"] = {"serve": _serve(arch, s, g),
                         "train": _train(arch, s, g, True)}
        anchor = torch.load(f"{out_dir}/anchor_params.pt",
                            weights_only=False)
        res["anchor"] = _serve(ANCHOR, ANCHOR_S, g, anchor, _anchor_cfg())
    finally:
        transformer._apply_block = orig
    res["rows"] = rows
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _jnp_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                  if a.dtype == jnp.bfloat16
                                  else np.asarray(a), tree)


@pytest.fixture(scope="module")
def seq_ranks(tmp_path_factory):
    from repro.models import model as jmodel
    d = tmp_path_factory.mktemp("seqshard")
    cfg = _anchor_cfg()
    from repro import configs as jconfigs
    jcfg = dataclasses.replace(jconfigs.get_reduced(ANCHOR),
                               compute_dtype="float32",
                               cache_dtype="float32")
    jparams = _jnp_tree(jmodel.init_params(jax.random.PRNGKey(1), jcfg))
    torch.save(convert.params_from_jax(jparams, cfg, "cpu"),
               d / "anchor_params.pt")
    mesh.spawn_ranks(_ranks, MSIZE, d / "store", args=(str(d),))
    out = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(MSIZE)]
    return out, jparams, jcfg


@pytest.fixture(scope="module")
def one():
    return {}


def _one(one, key, fn):
    if key not in one:
        one[key] = fn()
    return one[key]


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def _same_tree(got, want):
    bad = []
    tree_map_with_path(lambda p, a, b: None if torch.equal(a, b)
                       else bad.append(p), got, want)
    return bad


def test_every_block_boundary_holds_the_ranks_rows(seq_ranks):
    """Every block of every stack, in the forward passes and the
    recomputes, got the rank's ``split_range`` rows of its sequence:
    the prefills' and steps' S (15 too), decode's S = 1 (one row on rank
    0, none on ranks 1-3) and the encoder's frames."""
    ranks, _, _ = seq_ranks
    lengths = set()
    for r in range(MSIZE):
        rows = ranks[r]["rows"]
        assert rows and all(n is not None for n, _ in rows)
        for n, got in rows:
            assert got == sharding.split_range(n, MSIZE, r)[1], (r, n, got)
            lengths.add(n)
    assert {1, 15, S, ANCHOR_S} <= lengths


def _check_serve(got, want):
    for t, u in zip(got["tokens"], want["tokens"]):
        assert torch.equal(t, u)
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert torch.equal(a, b), i
    bad = _same_tree(got["stats"], want["stats"])
    assert not bad, bad[:5]


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_shard_serve_is_one_process_bit_for_bit(seq_ranks, one, arch):
    """The prefill's statistics (combined over the group) and logits, the
    greedy tokens and every decode step's logits: bit for bit."""
    ranks, _, _ = seq_ranks
    want = _one(one, ("serve", arch), lambda: _serve(arch, S))
    for r in range(MSIZE):
        _check_serve(ranks[r][arch]["serve"], want)


def _check_train(ranks, key, want, like):
    """Activation leaves bit for bit and the loss within 1e-5 relative;
    gradient leaves within 1e-5 of their largest element and gradients
    within 2**-7 relative L2; where the mesh's own step without
    ``seq_shard`` (saved as ``"tp"``) is farther, its quant state and loss
    bit for bit and the gradients within 2**-7 of its (the norms' sum
    over the rows moves their last bits)."""
    floor = "tp" in ranks[0][key]
    for r in range(MSIZE):
        got = ranks[r][key]["train"]
        if floor:
            tp = ranks[r][key]["tp"]
            assert not _same_tree(got["quant"], tp["quant"])
            assert got["loss"] == tp["loss"]
        bad, n = [], []

        def cmp(path, a, b):
            if "grad" in path:
                n.append(path)
                if not floor and float((a - b).abs().max()) > \
                        1e-5 * float(b.abs().max()):
                    bad.append(path)
            elif not torch.equal(a, b):
                bad.append(path)
        tree_map_with_path(cmp, got["quant"], want["quant"])
        assert not bad and n, bad[:5]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    whole = sharding.gather_named([ranks[r][key]["train"]["grads"]
                                   for r in range(MSIZE)], like)
    if floor:
        want = {"grads": sharding.gather_named(
            [ranks[r][key]["tp"]["grads"] for r in range(MSIZE)], like)}
    for k, g in want["grads"].items():
        assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_shard_train_step_within_the_model_axis_bars(seq_ranks, one,
                                                         arch):
    ranks, _, _ = seq_ranks
    want = _one(one, ("train", arch), lambda: _train(arch, S))
    like = dict(model.init_params(configs.get_reduced(arch), seed=0,
                                  device="cpu").named_parameters())
    _check_train(ranks, arch, want, like)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_shard_width10_forward(seq_ranks, arch):
    """Every site's (min, max, visited, clip, n) exact, err / sig within
    1e-4 (a site on the rank's rows sums them in another order)."""
    ranks, _, _ = seq_ranks
    want = _width10(arch)
    seen = [0]

    def cmp(path, a, b):
        assert a.shape[-1] == 10, path
        assert torch.equal(a[:T_N + 1], b[:T_N + 1]), (path, a, b)
        np.testing.assert_allclose(a[T_N + 1:T_UTIL].numpy(),
                                   b[T_N + 1:T_UTIL].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=str(path))
        seen[0] += int(b[2] > 0.5)
    for r in range(MSIZE):
        tree_map_with_path(cmp, ranks[r][arch]["tele"], want)
    assert seen[0] > 0


def test_uneven_rows_serve_and_train(seq_ranks, one):
    """S 15 over 4 ranks (4 / 4 / 4 / 3 rows) and decode's one row."""
    ranks, _, _ = seq_ranks
    arch, s = UNEVEN
    for r in range(MSIZE):
        _check_serve(ranks[r]["uneven"]["serve"], _serve(arch, s))
    like = dict(model.init_params(configs.get_reduced(arch), seed=0,
                                  device="cpu").named_parameters())
    _check_train(ranks, "uneven", _train(arch, s), like)


def test_seq_shard_prefill_against_the_reference(seq_ranks):
    """The ``seq_shard`` prefill of parameters converted from the JAX
    package's: logits and every statistic within
    ``tests/test_torch_serve.py``'s fp32 tolerance (1e-4) of the JAX
    ``model.prefill`` on the ``simulated`` backend."""
    from repro.core.policy import QuantPolicy as JPolicy
    from repro.models import model as jmodel
    ranks, jparams, jcfg = seq_ranks
    batch = data.for_arch(_anchor_cfg(), seq_len=ANCHOR_S, global_batch=B,
                          seed=1).batch(0)
    tokens = jnp.asarray(batch["tokens"].numpy().astype(np.int32))
    logits, _, stats = jmodel.prefill(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jmodel.init_quant_state(jcfg), {"tokens": tokens}, jcfg,
        JPolicy.w8a8g8(backend="simulated"), cache_len=ANCHOR_S + GEN,
        return_stats=True)
    want = jax.tree_util.tree_leaves_with_path(_jnp_tree(stats))
    for r in range(MSIZE):
        got = ranks[r]["anchor"]
        np.testing.assert_allclose(got["logits"][0].numpy(),
                                   np.asarray(logits), rtol=1e-4, atol=1e-4)
        leaves = jax.tree_util.tree_leaves_with_path(
            convert.to_jax_layout(got["stats"], _anchor_cfg()))
        assert [p for p, _ in leaves] == [p for p, _ in want]
        for (path, a), (_, b) in zip(leaves, want):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                                       atol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))
