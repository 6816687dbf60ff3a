"""The sequence-parallel attention core (the reference's second layout of
``attn_hints``) against the reference and the port's one-process
program, on the CPU.

* ``allow_seq``: the attention layer's dense-path predicate, captured at
  its ``attn_hints`` call in both packages (the reference's
  ``will_use_dense``), over a table of masks, lengths, caches and
  policies.
* ``sharding.attn_layout`` against the branch the reference's
  ``attn_hints`` takes over (KV, G, model size, S, allow_seq).
* The plain core with a query offset: the rows ``[q_start, q_start +
  sq)`` of a whole-sequence call, in each mask mode, aligned to the q
  blocks and not.  Against the port's own whole call: ``out``, ``m``,
  ``l`` bit for bit, the p-site (min, max, clip, n) exact once the calls
  are combined, err/sig within 1e-4 (a q block's tree split over two
  calls).  Against the reference's whole-sequence
  ``attention_core_reference``: the bounds of
  ``tests/test_torch_kernels.py`` (``m`` exact, ``l`` within 1e-5,
  ``out`` within 1e-4: exp differs by an ulp between XLA and PyTorch).
* Reduced command-r-35b (KV 2, G 2, causal) at S 32 and reduced
  starcoder2-3b (KV 2, G 2, window 16) at S 16 trained on ``(1, 4)`` (4
  gloo ranks, spawned once in a module fixture) under ``"seq"``, held
  against one process with ``tests/test_torch_tp.py``'s bounds; a
  telemetry (width-10) forward's p-sites exact in (min, max, visited,
  clip, n), err/sig within 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_attention as jattn
from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.state import tree_map_with_path
from repro_torch.kernels import int8_attention as tattn
from repro_torch.launch import mesh
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim.schedules import constant
from repro_torch.runtime import sharding, steps
from repro_torch.telemetry.config import T_CLIP, T_N, T_UTIL

from test_torch_kernels import _attn_inputs

POLICY = QuantPolicy.w8a8g8(backend="fused")
LR, B = 1e-3, 4
SEQ_ARCHS = (("command-r-35b", 32), ("starcoder2-3b", 16))
MSIZE = 4


# ---------------------------------------------------------------------------
# allow_seq against the reference's will_use_dense.
# ---------------------------------------------------------------------------
D, H, KV, HD, DENSE_MAX = 32, 4, 2, 8, 16
MODES = (("causal", None, None), ("sliding-past", 4, None),
         ("sliding-within", 64, None), ("prefix", None, 3),
         ("cross", None, None), ("bidir", None, None))


def _layer_cases():
    for mode, window, prefix in MODES:
        for s in (1, 8, 32):        # 1, <= DENSE_MAX, > DENSE_MAX
            for cached in (False, True):
                for pol in ("static", "dynamic"):
                    yield mode, window, prefix, s, cached, pol


@pytest.mark.parametrize("mode, window, prefix", MODES,
                         ids=[m[0] for m in MODES])
def test_allow_seq_is_the_references_will_use_dense(monkeypatch, mode,
                                                    window, prefix):
    """Each layer call's ``allow_seq`` at ``attn_hints`` in both
    packages, for S 1, <= and > ``dense_attn_max``, with and without a
    cache, on a static (the int8 core) and a dynamic (the fp paths)
    policy: equal everywhere, and true on some static calls (where the
    port once folded the core's use into it)."""
    from repro.core.policy import QuantPolicy as JPolicy
    from repro.models import attention as jattn_layer
    from repro_torch.models import attention as tattn_layer

    seen = {"j": [], "t": []}
    jorig, torig = jattn_layer.attn_hints, sharding.attn_hints

    def jspy(q, k, v, *, allow_seq):
        seen["j"].append(bool(allow_seq))
        return jorig(q, k, v, allow_seq=allow_seq)

    def tspy(q, k, v, *, allow_seq):
        seen["t"].append(bool(allow_seq))
        return torig(q, k, v, allow_seq=allow_seq)
    monkeypatch.setattr(jattn_layer, "attn_hints", jspy)
    monkeypatch.setattr(sharding, "attn_hints", tspy)
    name = mode.split("-")[0]
    tparams = tattn_layer.init_attention(torch.Generator().manual_seed(0),
                                         D, H, KV, HD, False)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    rng = np.random.default_rng(0)
    static_on = 0
    for _, window, prefix, s, cached, pol in (
            c for c in _layer_cases() if c[0] == mode):
        x = rng.standard_normal((1, s, D)).astype(np.float32)
        kv_x = rng.standard_normal((1, 8, D)).astype(np.float32) \
            if name == "cross" else None
        pos = np.broadcast_to(np.arange(s), (1, s)) + (7 if s == 1 else 0)
        kind = ("hindsight", "hindsight") if pol == "static" else \
            ("current", "current")
        kw = dict(n_heads=H, n_kv=KV, head_dim=HD, mode=name, window=window,
                  prefix_len=prefix, dense_attn_max=DENSE_MAX)
        jc = tc = None
        if cached:
            jc = jattn_layer.init_kv_cache(1, 40, KV, HD, jnp.float32)
            tc = tattn_layer.init_kv_cache(1, 40, KV, HD, torch.float32)
        jattn_layer.attention_layer(
            jparams, jattn_layer.init_attention_sites(), jnp.asarray(x),
            positions=jnp.asarray(pos), cache=jc,
            kv_x=None if kv_x is None else jnp.asarray(kv_x),
            policy=JPolicy.w8a8g8(*kind), seed=jnp.int32(0),
            step=jnp.int32(0), **kw)
        with torch.no_grad():
            tattn_layer.attention_layer(
                tparams, tattn_layer.init_attention_sites(),
                torch.from_numpy(x), positions=torch.from_numpy(pos.copy()),
                cache=tc,
                kv_x=None if kv_x is None else torch.from_numpy(kv_x),
                policy=QuantPolicy.w8a8g8(*kind), seed=0, step=0, **kw)
        assert seen["t"][-1] == seen["j"][-1], (mode, s, cached, pol)
        static_on += pol == "static" and seen["t"][-1]
    assert len(seen["t"]) == len(seen["j"]) == 12
    assert static_on == (0 if mode == "sliding-past" else 1)


# ---------------------------------------------------------------------------
# attn_layout against the reference's branch.
# ---------------------------------------------------------------------------
def _reference_branch(monkeypatch, kv, g, msize, s, allow_seq) -> str:
    """The branch the reference's ``attn_hints`` takes: "heads" (exact),
    "seq" or "padded", read from the calls it makes."""
    import jax
    from repro.runtime import sharding as jsh
    calls = []
    monkeypatch.setattr(jsh, "hint_heads",
                        lambda q, **kw: calls.append("heads") or q)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: calls.append(tuple(spec)) or x)
    q = np.zeros((1, s, kv, g, 1), np.int8)
    k = np.zeros((1, s, kv, 1), np.int8)
    with jsh.activation_hints({"model": "model", "model_size": msize,
                               "batch": "data"}):
        jsh.attn_hints(q, k, k, allow_seq=allow_seq)
    if calls == ["heads"] * 3:
        return "heads"
    if calls == ["heads"]:
        return "padded"
    assert calls and calls[0][1] == "model", calls
    return "seq"


def test_attn_layout_is_the_references_branch(monkeypatch):
    """Over KV, G in {1, 2, 3, 8, 12}, the model size 2-16, S 1-48 and
    ``allow_seq``: ``"kv"`` / ``"g"`` where the reference shards heads
    exactly (KV first), ``"seq"`` where it shards the sequence, and the
    padded layout of the dim ``choose_head_axis`` picks (``"g_pad"`` /
    ``"kv_pad"``) where it pads the heads."""
    counts = {"heads": 0, "seq": 0, "padded": 0}
    for kv in (1, 2, 3, 8, 12):
        for g in (1, 2, 3, 8, 12):
            for msize in (2, 4, 8, 16):
                for s in (1, 16, 24, 48):
                    for allow in (False, True):
                        want = _reference_branch(monkeypatch, kv, g, msize,
                                                 s, allow)
                        counts[want] += 1
                        got = sharding.attn_layout(kv, g, msize, s, allow)
                        if want == "padded":
                            assert got == sharding.choose_head_axis(
                                kv, g, msize) + "_pad", (kv, g, msize)
                            assert got == ("g_pad" if g >= kv
                                           else "kv_pad"), (kv, g, msize)
                        elif want == "seq":
                            assert got == "seq", (kv, g, msize, s, allow)
                        else:
                            assert got == ("kv" if kv % msize == 0
                                           else "g"), (kv, g, msize)
    assert all(counts.values()), counts


# ---------------------------------------------------------------------------
# The plain core with a query offset.
# ---------------------------------------------------------------------------
OFFSET_CASES = [
    # mode, S, groups, hd, window, prefix, (bq, bkv), parts
    ("causal", 64, 2, 16, 0, 0, (16, 16), 4),
    ("causal", 48, 1, 16, 0, 0, (32, 16), 4),      # 12-row parts
    ("sliding", 64, 2, 16, 20, 0, (16, 8), 4),
    ("sliding", 96, 1, 8, 24, 0, (32, 32), 3),
    ("prefix", 64, 2, 16, 0, 21, (16, 16), 4),
    ("bidir", 40, 1, 16, 0, 0, (16, 16), 4),       # 10-row parts
    ("cross", 32, 2, 16, 0, 0, (8, 16), 4),
]


@pytest.mark.parametrize("case", OFFSET_CASES,
                         ids=lambda c: f"{c[0]}-S{c[1]}-bq{c[6][0]}")
def test_offset_core_is_rows_of_the_whole_call(case):
    mode, s, groups, hd, window, prefix, (bq, bkv), parts = case
    skv = 40 if mode == "cross" else s
    kw = dict(sq=s, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=groups,
              mode=mode, window=window, prefix_len=prefix,
              sm_scale=hd ** -0.5)
    sched = tattn.make_schedule(**kw)
    q, k, v, regs = _attn_inputs(s, skv, groups, hd, seed=s + hd,
                                 zps=(127.0, 0.0, 1.0, 3.0))
    kvl = np.array([[skv - 3 if mode == "cross" else skv]], np.int32)
    qt, kt, vt, rt, lt = (torch.from_numpy(a) for a in (q, k, v, regs, kvl))
    out, ml, ps = tattn.attention_core_reference(qt, kt, vt, rt, lt,
                                                 sched=sched)
    oj, mlj, _ = jattn.attention_core_reference(
        *(jnp.asarray(a) for a in (q, k, v, regs, kvl)),
        sched=jattn.make_schedule(**kw))
    n = s // parts
    outs, mls, pss = [], [], []
    for r in range(parts):
        o, m, p = tattn.attention_core_reference(
            qt[:, r * n:(r + 1) * n], kt, vt, rt, lt, sched=sched,
            q_start=r * n)
        outs.append(o)
        mls.append(m)
        pss.append(p)
        lead, i0, nq = tattn.row_blocks(sched, r * n, n)
        assert p.shape == (q.shape[0], nq, 6)
    got_out, got_ml = torch.cat(outs, 1), torch.cat(mls, 1)
    assert torch.equal(got_out, out)
    assert torch.equal(got_ml, ml)
    whole = torch.stack(tattn.reduce_pstats(ps))
    split = [torch.stack(tattn.reduce_pstats(p)) for p in pss]
    comb = torch.stack([min(t[0] for t in split), max(t[1] for t in split),
                        sum(t[2] for t in split), sum(t[3] for t in split),
                        sum(t[4] for t in split), sum(t[5] for t in split)])
    assert torch.equal(comb[:4], whole[:4])
    np.testing.assert_allclose(comb[4:].numpy(), whole[4:].numpy(),
                               rtol=1e-4, atol=1e-6)
    # against the reference's whole-sequence oracle
    mlj = np.asarray(mlj)
    np.testing.assert_array_equal(mlj[..., 0], got_ml[..., 0].numpy())
    np.testing.assert_allclose(mlj[..., 1], got_ml[..., 1].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj), got_out.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", OFFSET_CASES[:3],
                         ids=lambda c: f"{c[0]}-S{c[1]}-bq{c[6][0]}")
def test_offset_core_backward_sums_to_the_whole(case):
    """The offset calls' ``dq`` are the whole call's rows, and their
    ``dk`` / ``dv`` shares sum to the whole call's (fp32, another
    order: within 1e-5 of the largest element)."""
    mode, s, groups, hd, window, prefix, (bq, bkv), parts = case
    kw = dict(sq=s, skv=s, hd=hd, bq=bq, bkv=bkv, groups=groups, mode=mode,
              window=window, prefix_len=prefix, sm_scale=hd ** -0.5)
    sched = tattn.make_schedule(**kw)
    q, k, v, regs = _attn_inputs(s, s, groups, hd, seed=s + hd + 1,
                                 zps=(127.0, 0.0, 1.0, 3.0))
    qt, kt, vt, rt = (torch.from_numpy(a) for a in (q, k, v, regs))
    lt = torch.tensor([[s]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    qh = (qt.float() - 127) * 0.02
    kh, vh = kt.float() * 0.01, vt.float() * 0.01
    g_out = torch.randn(qt.shape, generator=gen)
    out, ml, _ = tattn.attention_core_reference(qt, kt, vt, rt, lt,
                                                sched=sched)
    want = tattn.attention_core_backward(qh, kh, vh, qt, kt, vt, rt, lt, out,
                                         ml, g_out, sched=sched)
    n = s // parts
    dqs, dk, dv = [], 0, 0
    for r in range(parts):
        rows = slice(r * n, (r + 1) * n)
        o, m, _ = tattn.attention_core_reference(qt[:, rows], kt, vt, rt, lt,
                                                 sched=sched, q_start=r * n)
        a, b, c = tattn.attention_core_backward(
            qh[:, rows], kh, vh, qt[:, rows], kt, vt, rt, lt, o, m,
            g_out[:, rows], sched=sched, q_start=r * n)
        dqs.append(a)
        dk, dv = dk + b, dv + c
    assert torch.equal(torch.cat(dqs, 1), want[0])
    for got, w in ((dk, want[1]), (dv, want[2])):
        assert float((got - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_offset_rows_must_lie_in_the_call():
    sched = tattn.make_schedule(sq=32, skv=32, hd=8, bq=16, bkv=16,
                                groups=1, mode="causal", sm_scale=1.0)
    with pytest.raises(ValueError, match="not within"):
        tattn.row_blocks(sched, 24, 16)
    assert tattn.row_blocks(sched, 8, 16) == (8, 0, 2)
    assert tattn.row_blocks(dataclasses.replace(sched, bq=8), 8, 8) == \
        (0, 1, 1)


# ---------------------------------------------------------------------------
# The train step under "seq" on (1, 4).
# ---------------------------------------------------------------------------
class _Spy:
    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params, lr)


def _train(arch, s, groups=None):
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
    batch = data.for_arch(cfg, seq_len=s, global_batch=B, seed=0).batch(0)
    st, met = ts(st, batch)
    return {"loss": float(met["loss"]), "quant": st["quant"],
            "grads": opt.grads}


def _width10(arch, s, model_group=None, coords=None):
    """A telemetry forward's statistics (combined over the model
    group)."""
    cfg = configs.get_reduced(arch)
    tele = POLICY.with_telemetry(enabled=True)
    params = model.init_params(cfg, seed=0, device="cpu")
    if model_group is not None:
        params = sharding.shard_params(params, coords, {"model": MSIZE})
    quant = model.init_quant_state(cfg, tele, device="cpu")
    batch = data.for_arch(cfg, seq_len=s, global_batch=B, seed=0).batch(0)
    with torch.no_grad(), sharding.model_parallel(model_group):
        _, (fwd, _) = model.loss_fn(params, quant, batch, cfg, tele, 0, 0)
    if model_group is not None:
        fwd = steps.dp_combine_stats(fwd, model_group)
    return fwd


def _ranks(rank, world, out_dir):
    g = mesh.mesh_groups(1, MSIZE)
    res = {}
    for arch, s in SEQ_ARCHS:
        layouts = []
        orig = sharding.attn_layout

        def spy(*a, **kw):
            layouts.append(orig(*a, **kw))
            return layouts[-1]
        sharding.attn_layout = spy
        try:
            res[arch] = _train(arch, s, g)
        finally:
            sharding.attn_layout = orig
        res[arch]["layouts"] = sorted(set(layouts))
        res[arch]["tele"] = _width10(arch, s, g.model, g.coords)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def seq_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqpar")
    mesh.spawn_ranks(_ranks, MSIZE, d / "store", args=(str(d),))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(MSIZE)]


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


@pytest.mark.parametrize("arch, s", SEQ_ARCHS, ids=[a for a, _ in SEQ_ARCHS])
def test_seq_train_step_matches_one_process(seq_ranks, arch, s):
    """Every rank ran the ``"seq"`` layout; the quant state's activation
    leaves bit for bit, gradient leaves within 1e-5 of their largest
    element, the loss within 1e-5 relative, the gradients (the attention
    weights gathered whole, summed over the group; each rank keeps its
    heads' share of ``wq`` / ``wo`` / ``bq``) within 2**-7 relative L2."""
    want = _train(arch, s)
    like = dict(model.init_params(configs.get_reduced(arch), seed=0,
                                  device="cpu").named_parameters())
    for r in range(MSIZE):
        got = seq_ranks[r][arch]
        assert got["layouts"] == ["seq"], got["layouts"]
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
    whole = sharding.gather_named([seq_ranks[r][arch]["grads"]
                                   for r in range(MSIZE)], like)
    for k, g in want["grads"].items():
        assert _rel_l2(whole[k], g) <= 2 ** -7, (k, _rel_l2(whole[k], g))
        if ".attn." in k and sharding.compute_dim(
                tuple(k.split(".")), tuple(g.shape), MSIZE) is None:
            for r in range(1, MSIZE):   # replicated, summed once
                assert torch.equal(seq_ranks[r][arch]["grads"][k],
                                   seq_ranks[0][arch]["grads"][k]), k


@pytest.mark.parametrize("arch, s", SEQ_ARCHS, ids=[a for a, _ in SEQ_ARCHS])
def test_seq_p_sites_at_width_10(seq_ranks, arch, s):
    """A telemetry forward under ``"seq"``: each attention core's p-site
    (min, max, visited, clip, n) exact, err/sig within 1e-4."""
    want = _width10(arch, s)
    n = [0]

    def cmp(path, a, b):
        if path[-3:-1] != ("core", "p"):
            return
        n[0] += 1
        assert torch.equal(a[:3], b[:3]), path
        assert torch.equal(a[T_CLIP:T_N + 1], b[T_CLIP:T_N + 1]), path
        np.testing.assert_allclose(a[T_N + 1:T_UTIL].numpy(),
                                   b[T_N + 1:T_UTIL].numpy(), rtol=1e-4,
                                   atol=1e-7)
    for r in range(MSIZE):
        tree_map_with_path(cmp, seq_ranks[r][arch]["tele"], want)
    assert n[0] == MSIZE * configs.get_reduced(arch).n_layers
