"""Port vs reference: the hybrid family (recurrentgemma-9b: ``"rec"``
RG-LRU blocks and ``"local"`` sliding-window attention blocks) at reduced
size on the CPU (the RG-LRU layer alone: ``test_torch_rglru.py``).

The reference's ``init_params`` / train state are carried across with
``repro_torch.convert``; prompts are made with numpy from a seed.  The
reduced config has 5 layers, ``(rec, rec, local)`` once and a ``(rec,
rec)`` tail, and a local window of 16: a 32-token prompt runs the int8
attention core under a sliding mask that masks, and decode wraps the
16-slot ring.

Tolerances, stated per test:
  * prefill and decode in bf16 compute (the config's), hindsight, against
    the reference compiled as written with XLA's bf16 excess precision off
    (``test_torch_conv.compile_as_written_bf16``): every site's prefill
    statistics, the bf16 caches (conv tails, ring k/v/pos) bit for bit;
    the fp32 logits and the recurrent states ``h`` within 2e-6 (the
    logits product sums in another order, and ``h`` carries XLA's
    ``exp``/``logistic`` ulps); against plain ``jax.jit`` (which keeps
    fused bf16 intermediates in fp32) the logits within 8e-2 relative L2
    and 0.25 absolute (observed 4.3e-2 and 0.15);
  * the port's own prefill-then-decode consistency under
    ``QuantPolicy.disabled()``: the reference's ``rtol 2e-2, atol 2e-3``
    (``tests/test_models.py::test_prefill_decode_consistency``) in bf16
    compute, 1e-5 in fp32 compute;
  * one train step against the reference compiled as written: the loss
    within 1e-6 relative, every quant leaf bit for bit, the parameters
    within 1e-6.  (Against plain ``jax.jit`` the bf16 excess precision
    moves the gradient sites' ranges by up to 1.6e-1 relative; in fp32
    compute they agree within 5.2e-3, stochastic rounding's level flips.)
The port's two backends agree bit for bit on the CPU throughout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro.core import backend as jbackend
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.runtime import steps as jsteps
from repro_torch import configs, convert, data
from repro_torch import optim as topt
from repro_torch.core import backend as tbackend
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.launch import serve, train
from repro_torch.models import model as tmodel
from repro_torch.runtime import steps as tsteps

from test_torch_conv import compile_as_written_bf16

ARCH = "recurrentgemma-9b"
B, MS, GEN = 2, 32, 6


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.array(a), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


# ---------------------------------------------------------------------------
# The config and the layout.
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    for get in ("get", "get_reduced"):
        cj, ct = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), (get, f.name)
    assert configs.get(ARCH).family == "hybrid"
    assert data.for_arch(configs.get_reduced(ARCH), 8, 2).batch(0)[
        "tokens"].shape == (2, 8)


def test_full_config_parameter_count():
    """9.40 B parameters (37.6 GB in fp32): 26 rec layers, 12 local layers
    and the tied embedding, counted from the reference's shapes."""
    cfg = jconfigs.get(ARCH)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert round(n / 1e9, 2) == 9.40
    assert "head" not in shapes


def _wide_deep():
    """The reduced widths at the full config's 38 layers: 12 (rec, rec,
    local) units and a (rec, rec) tail."""
    return (dataclasses.replace(jconfigs.get_reduced(ARCH), n_layers=38),
            dataclasses.replace(configs.get_reduced(ARCH), n_layers=38))


def test_convert_round_trip_of_the_38_layer_layout():
    """Params, quant state and the decode caches: the reference's stacked
    ``[12, ...]`` unit leaves and its two tail blocks to the port's 38
    layers and back, bit for bit; the fp32 RG-LRU leaves keep their
    dtype."""
    cfg_j, cfg_t = _wide_deep()
    rng = np.random.default_rng(0)

    def rand(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32), tree)
    trees = {
        "params": rand(jax.eval_shape(lambda k: jmodel.init_params(k, cfg_j),
                                      jax.random.PRNGKey(0))),
        "quant": rand(_np(jmodel.init_quant_state(cfg_j))),
        "cache": rand(jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 2,
                                                               40))),
    }
    assert trees["params"]["decoder"]["blocks"]["b0"]["rglru"]["w_a"] \
        .shape[0] == 12
    assert set(trees["params"]["decoder"]["tail"]) == {"t0", "t1"}
    pt = convert.params_from_jax(trees["params"], cfg_t, "cpu")
    kinds = [("rglru" in lay._names, "attn" in lay._names)
             for lay in pt["decoder"]["layers"]]
    assert kinds == [(True, False), (True, False), (False, True)] * 12 + \
        [(True, False)] * 2
    np.testing.assert_array_equal(
        pt["decoder"]["layers"][37]["rglru"]["lambda"].numpy(),
        trees["params"]["decoder"]["tail"]["t1"]["rglru"]["lambda"])
    np.testing.assert_array_equal(
        pt["decoder"]["layers"][35]["attn"]["wq"].numpy(),
        trees["params"]["decoder"]["blocks"]["b2"]["attn"]["wq"][11])
    back = {"params": convert.params_to_jax(pt, cfg_t)}
    for key in ("quant", "cache"):
        tree = convert.from_jax_layout({"decoder": trees[key]["decoder"]},
                                       cfg_t, "cpu")
        back[key] = convert.to_jax_layout(tree, cfg_t)
        if key == "cache":
            got = tree["decoder"]["layers"]
            assert set(got[0]) == {"h", "conv"}
            assert set(got[2]["kv"]) == {"k", "v", "pos"}
    for key, tree in trees.items():
        lr, lb = _leaves(tree["decoder"]), _leaves(back[key]["decoder"])
        assert [p for p, _ in lr] == [p for p, _ in lb]
        for (path, a), (_, b) in zip(lr, lb):
            np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))


def test_decode_state_shapes():
    """Each rec block carries ``h`` fp32 ``[B, lru_width]`` and a 3-row conv
    tail in the cache dtype; each local block a ring of ``local_window``
    slots however long the cache."""
    cfg = configs.get_reduced(ARCH)
    caches = tmodel.init_cache(cfg, 2, 100, "cpu")["decoder"]["layers"]
    for i, c in enumerate(caches):
        if i % 3 == 2 and i < 36:
            assert c["kv"]["k"].shape == (2, cfg.local_window, 1, 16)
        else:
            assert c["h"].shape == (2, cfg.lru_width)
            assert c["h"].dtype == torch.float32
            assert c["conv"].shape == (2, 3, cfg.lru_width)
            assert c["conv"].dtype == torch.bfloat16
    short = tmodel.init_cache(cfg, 2, 8, "cpu")["decoder"]["layers"][2]
    assert short["kv"]["k"].shape[1] == 8


# ---------------------------------------------------------------------------
# Prefill and decode past the ring's wrap.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_case():
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg_j.vocab, (B, MS)).astype(np.int32)
    nxt = rng.integers(0, cfg_j.vocab, (GEN, B, 1)).astype(np.int32)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    policy = JPolicy.w8a8g8(backend="simulated")

    def pf(p, q, b):
        return jmodel.prefill(p, q, b, cfg_j, policy, cache_len=MS + GEN,
                              return_stats=True)

    def df(p, q, t, pos, c):
        return jmodel.decode_step(p, q, t, pos, c, cfg_j, policy)

    out = {}
    pargs = (params_j, quant_j, {"tokens": jnp.asarray(tokens)})
    for name, compile_ in (("written", compile_as_written_bf16),
                           ("jit", lambda f, *a: jax.jit(f))):
        logits, caches, stats = compile_(pf, *pargs)(*pargs)
        decode = None
        steps = []
        for i in range(GEN):
            dargs = (params_j, quant_j, jnp.asarray(nxt[i]),
                     jnp.full((B,), MS + i, jnp.int32), caches)
            decode = decode or compile_(df, *dargs)
            lg, caches = decode(*dargs)
            steps.append(np.asarray(lg))
        out[name] = dict(logits=np.asarray(logits), steps=steps,
                         stats=_np(stats), caches=_np(caches))
    params_t = convert.params_from_jax(_np(params_j), cfg_t, "cpu")
    for bk in ("simulated", "fused"):
        pol = TPolicy.w8a8g8(backend=bk)
        quant_t = convert.from_jax_layout(_np(quant_j), cfg_t, "cpu")
        lt, caches, st = tmodel.prefill(
            params_t, quant_t, {"tokens": torch.from_numpy(tokens).long()},
            cfg_t, pol, cache_len=MS + GEN, return_stats=True)
        steps = []
        for i in range(GEN):
            lg, caches = tmodel.decode_step(
                params_t, quant_t, torch.from_numpy(nxt[i]).long(),
                torch.full((B,), MS + i, dtype=torch.long), caches, cfg_t,
                pol)
            steps.append(lg.numpy())
        out[bk] = dict(logits=lt.numpy(), steps=steps,
                       stats=convert.to_jax_layout(st, cfg_t),
                       caches=convert.to_jax_layout(caches, cfg_t))
    return out


def test_hybrid_prefill_stats_bit_equal_to_reference_as_written(model_case):
    ref = model_case["written"]["stats"]
    lr = _leaves(ref)
    names = [jax.tree_util.keystr(p) for p, _ in lr]
    for site in ("in", "gate", "a", "x", "out"):
        assert any(f"['rglru']['{site}']['act']" in n for n in names)
    assert any("['tail']['t1']['rglru']" in n for n in names)
    assert any("['attn']['core']['p']" in n for n in names)
    for bk in ("simulated", "fused"):
        lt = _leaves(model_case[bk]["stats"])
        assert [p for p, _ in lt] == [p for p, _ in lr]
        for (path, a), (_, b) in zip(lr, lt):
            np.testing.assert_array_equal(
                a, b, f"{bk}{jax.tree_util.keystr(path)}")


def test_hybrid_logits_match_reference_as_written(model_case):
    ref = model_case["written"]
    for bk in ("simulated", "fused"):
        got = model_case[bk]
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=0,
                                   atol=2e-6, err_msg=f"{bk} prefill")
        for i, (a, b) in enumerate(zip(ref["steps"], got["steps"])):
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-6,
                                       err_msg=f"{bk} decode step {i}")


def test_hybrid_caches_after_the_wrap_match_reference(model_case):
    """After MS + GEN = 38 positions: the local rings hold the last 16
    positions (wrapped), the bf16 k/v and conv tails bit for bit, the
    recurrent states within 2e-6."""
    ref = model_case["written"]["caches"]
    ring = ref["decoder"]["blocks"]["b2"]["kv"]["pos"][0]       # [B, 16]
    assert ring.shape == (B, 16)
    np.testing.assert_array_equal(
        np.sort(ring, axis=-1),
        np.broadcast_to(np.arange(MS + GEN - 16, MS + GEN), (B, 16)))
    for bk in ("simulated", "fused"):
        lr, lt = _leaves(ref), _leaves(model_case[bk]["caches"])
        assert [p for p, _ in lr] == [p for p, _ in lt]
        for (path, a), (_, b) in zip(lr, lt):
            name = jax.tree_util.keystr(path)
            if name.endswith("['h']"):
                np.testing.assert_allclose(b, a, rtol=0, atol=2e-6,
                                           err_msg=f"{bk}{name}")
            else:
                np.testing.assert_array_equal(a, b, f"{bk}{name}")


def test_hybrid_logits_near_plain_jit(model_case):
    ref = model_case["jit"]
    for bk in ("simulated", "fused"):
        got = model_case[bk]
        for what, a, b in [("prefill", ref["logits"], got["logits"])] + [
                (f"decode {i}", x, y) for i, (x, y) in enumerate(
                    zip(ref["steps"], got["steps"]))]:
            assert np.abs(b - a).max() <= 0.25, (bk, what)
            assert np.linalg.norm(b - a) <= 8e-2 * np.linalg.norm(a), (
                bk, what)


def test_hybrid_model_port_backends_bitwise(model_case):
    sim, fus = model_case["simulated"], model_case["fused"]
    np.testing.assert_array_equal(sim["logits"], fus["logits"])
    for a, b in zip(sim["steps"], fus["steps"]):
        np.testing.assert_array_equal(a, b)
    for (path, a), (_, b) in zip(_leaves(sim["stats"]) +
                                 _leaves(sim["caches"]),
                                 _leaves(fus["stats"]) +
                                 _leaves(fus["caches"])):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [16, 21])
def test_prefill_decode_consistency(s, dtype):
    """The reference's ``test_prefill_decode_consistency`` on the port,
    decoding on past the local ring's wrap: after each step, the decode
    logits equal a prefill of the extended sequence within rtol 2e-2,
    atol 2e-3 (``QuantPolicy.disabled()``, no quantization noise) in the
    config's bf16 compute, and within 1e-5 in fp32 compute (the same
    arithmetic in another order; observed 2e-6)."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), compute_dtype=dtype,
                              cache_dtype=dtype)
    tol = (2e-2, 2e-3) if dtype == "bfloat16" else (1e-5, 1e-5)
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    qs = tmodel.init_quant_state(cfg, device="cpu")
    policy = TPolicy.disabled()
    gen = torch.Generator().manual_seed(s)
    tokens = torch.randint(0, cfg.vocab, (2, s), generator=gen)
    logits, cache = tmodel.prefill(params, qs, {"tokens": tokens}, cfg,
                                   policy, cache_len=s + 8)
    for i in range(6):
        tok = torch.argmax(logits, -1)[:, None]
        logits, cache = tmodel.decode_step(
            params, qs, tok, torch.full((2,), s + i), cache, cfg, policy)
        tokens = torch.cat([tokens, tok], dim=1)
        again, _ = tmodel.prefill(params, qs, {"tokens": tokens}, cfg,
                                  policy, cache_len=s + 8)
        np.testing.assert_allclose(logits.numpy(), again.numpy(),
                                   rtol=tol[0], atol=tol[1],
                                   err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------
LR, SEQ, TB = 3e-3, 32, 2


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


def test_hybrid_train_step_matches_jax_simulated(monkeypatch):
    """One AdamW step from the reference's init state, batch and noise
    (bf16 compute), the reference compiled as written with XLA's bf16
    excess precision off: the loss within 1e-6 relative, every quant leaf
    (activation and gradient sites, RG-LRU's included) bit for bit after
    the update, every parameter within 1e-6 (observed 3.1e-7: the
    backward's fp32 sums run in another order, and no AdamW sign flips);
    the port's two backends bit-equal."""
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    policy = JPolicy.w8a8g8(backend="simulated")
    init = _np(jax.jit(lambda k: jsteps.init_train_state(
        k, cfg_j, jadamw(weight_decay=0.0), policy))(jax.random.PRNGKey(0)))
    batch = _np(jdata.for_arch(cfg_j, seq_len=SEQ, global_batch=TB,
                               seed=0).batch(0))
    args = (jax.tree_util.tree_map(jnp.asarray, init),
            jax.tree_util.tree_map(jnp.asarray, batch))
    state, met = compile_as_written_bf16(jsteps.make_train_step(
        cfg_j, policy, jadamw(weight_decay=0.0), jsched.constant(LR)),
        *args)(*args)
    ref = _np(state)
    loss_r = float(met["loss"])
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)
    port = {}
    for bk in ("simulated", "fused"):
        opt = topt.adamw(weight_decay=0.0)
        st = convert.train_state_from_jax(init, cfg_t, opt, "cpu")
        step = tsteps.make_train_step(cfg_t, TPolicy.w8a8g8(backend=bk), opt,
                                      topt.constant(LR))
        st, m = step(st, {k: torch.from_numpy(np.array(v)).to(
            torch.int64 if np.asarray(v).dtype.kind in "iu"
            else torch.float32) for k, v in batch.items()})
        port[bk] = (float(m["loss"]),
                    convert.to_jax_layout(st["quant"], cfg_t),
                    convert.params_to_jax(st["params"], cfg_t))
    for bk, (loss_t, quant_t, params_t) in port.items():
        assert abs(loss_t - loss_r) <= 1e-6 * abs(loss_r), (bk, loss_t,
                                                             loss_r)
        lq_r, lq_t = _leaves(ref["quant"]), _leaves(quant_t)
        assert [p for p, _ in lq_r] == [p for p, _ in lq_t]
        assert any("['rglru']['gate']['grad']" in jax.tree_util.keystr(p)
                   for p, _ in lq_r)
        for (path, a), (_, b) in zip(lq_r, lq_t):
            np.testing.assert_array_equal(
                a, b, f"{bk} {jax.tree_util.keystr(path)}")
        lp_r, lp_t = _leaves(ref["params"]), _leaves(params_t)
        assert [p for p, _ in lp_r] == [p for p, _ in lp_t]
        assert any("['rglru']['lambda']" in jax.tree_util.keystr(p)
                   for p, _ in lp_r)
        for (path, a), (_, b) in zip(lp_r, lp_t):
            np.testing.assert_allclose(
                b, a, rtol=0, atol=1e-6,
                err_msg=f"{bk} {jax.tree_util.keystr(path)}")
    (ls, qs, ps), (lf, qf, pf) = port["simulated"], port["fused"]
    assert ls == lf
    for (path, a), (_, b) in zip(_leaves(qs) + _leaves(ps),
                                 _leaves(qf) + _leaves(pf)):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The drivers.
# ---------------------------------------------------------------------------
def test_serve_driver_runs_hybrid_on_cpu():
    run = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "24", "--gen", "12"])
    assert run.tokens.shape == (2, 12)
    assert torch.isfinite(run.prefill_logits).all()
    layers = run.prefill_stats["decoder"]["layers"]
    assert "rglru" in layers[0] and "attn" in layers[2]


def test_train_driver_runs_hybrid_on_cpu():
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "32"])
    assert len(run.losses) == 2 and np.all(np.isfinite(run.losses))
