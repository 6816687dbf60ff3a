"""Port vs reference: the serving slice end to end at reduced size.

The JAX package's ``init_params(PRNGKey(1), reduced starcoder2-3b)`` is
converted with ``repro_torch.convert`` and both packages run ``prefill``
(returning the forward stats tree and the KV caches) and one
``decode_step`` on the same tokens.  The reference is the JAX
``simulated`` backend (bit-identical to its fused backend on the serving
forward).  The prompt (24 tokens) exceeds the sliding window (16), so the
decode cache is a wrapped ring buffer, and ``REPRO_ATTN_BLOCK=8,8`` makes
the attention core walk a 3 x 3 block schedule.

Tolerances.  ``compute_dtype=float32``: the int8 contractions and
min/max statistics are exact, but exp/tanh/cos/rsqrt and the norms'
reductions differ by ulps between XLA and PyTorch, which can move an
activation across a rounding boundary of its 8-bit grid (one level) — so
values are compared at 1e-4 relative.  ``bfloat16`` (the default): the
jitted reference keeps some fused bf16 intermediates in fp32 where its
written ops round them (compiled without that excess precision it equals
the port's prefill site for site, ``tests/test_torch_gelu.py``); such a
difference flips the bf16 rounding
of an activation (2**-8 relative) and with it its 8-bit level, and the
flips compound through the layers — so tensors are held to a relative L2
error of 2e-2 (observed <= 1.67e-2) and an elementwise bound of 0.1
absolute + 5e-2 relative (logits have unit scale at init; one flipped
level moves a logit by about 0.03).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.launch import serve
from repro_torch.models import model as tmodel

B, S, GEN = 2, 24, 4


def _close(actual, desired, compute_dtype, what):
    actual = np.asarray(actual, np.float32)
    desired = np.asarray(desired, np.float32)
    if compute_dtype == "float32":
        np.testing.assert_allclose(actual, desired, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
        return
    np.testing.assert_allclose(actual, desired, rtol=5e-2, atol=0.1,
                               err_msg=what)
    err = np.linalg.norm(actual - desired)
    assert err <= 2e-2 * max(np.linalg.norm(desired), 1e-6), what


def _cfgs(compute_dtype, cache_dtype):
    kw = dict(compute_dtype=compute_dtype, cache_dtype=cache_dtype)
    return (dataclasses.replace(jconfigs.get_reduced("starcoder2-3b"), **kw),
            dataclasses.replace(tconfigs.get_reduced("starcoder2-3b"), **kw))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                  if a.dtype == jnp.bfloat16
                                  else np.asarray(a), tree)


@pytest.fixture(scope="module", params=[("float32", "float32"),
                                        ("bfloat16", "bfloat16"),
                                        ("bfloat16", "int8")],
                ids=["f32", "bf16", "bf16-int8cache"])
def case(request):
    compute_dtype, cache_dtype = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_ATTN_BLOCK", "8,8")
        cfg_j, cfg_t = _cfgs(compute_dtype, cache_dtype)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32)
        nxt = rng.integers(0, cfg_j.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S, np.int32)

        params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
        quant_j = jmodel.init_quant_state(cfg_j)
        policy_j = JPolicy.w8a8g8(backend="simulated")
        prefill = jax.jit(lambda p, q, b: jmodel.prefill(
            p, q, b, cfg_j, policy_j, cache_len=S + GEN, return_stats=True))
        decode = jax.jit(lambda p, q, t, ps, c: jmodel.decode_step(
            p, q, t, ps, c, cfg_j, policy_j))
        logits_j, caches_j, stats_j = prefill(params_j, quant_j,
                                              {"tokens": jnp.asarray(tokens)})
        dlogits_j, _ = decode(params_j, quant_j, jnp.asarray(nxt),
                              jnp.asarray(pos), caches_j)
        ref = dict(logits=np.asarray(logits_j), caches=_np(caches_j),
                   stats=_np(stats_j), dlogits=np.asarray(dlogits_j))

        params_t = convert.params_from_jax(_np(params_j), cfg_t, "cpu")
        port = {}
        for backend in ("simulated", "fused"):
            quant_t = convert.from_jax_layout(_np(quant_j), cfg_t, "cpu")
            policy_t = TPolicy.w8a8g8(backend=backend)
            logits, caches, stats = tmodel.prefill(
                params_t, quant_t, {"tokens": torch.from_numpy(tokens).long()},
                cfg_t, policy_t, cache_len=S + GEN, return_stats=True)
            snap = convert.to_jax_layout(caches, cfg_t)
            dlogits, _ = tmodel.decode_step(
                params_t, quant_t, torch.from_numpy(nxt).long(),
                torch.from_numpy(pos).long(), caches, cfg_t, policy_t)
            port[backend] = dict(
                logits=logits.numpy(), caches=snap,
                stats=convert.to_jax_layout(stats, cfg_t),
                dlogits=dlogits.numpy())
    return compute_dtype, cache_dtype, ref, port


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_prefill_and_decode_logits_match_jax(case):
    compute_dtype, _, ref, port = case
    for backend, out in port.items():
        _close(out["logits"], ref["logits"], compute_dtype,
               f"{backend} prefill")
        _close(out["dlogits"], ref["dlogits"], compute_dtype,
               f"{backend} decode")


def test_prefill_stats_tree_matches_jax_site_by_site(case):
    """Every activation site's observed (min, max, visited), in the JAX
    layout: same tree, same visited flags, values within tolerance."""
    compute_dtype, _, ref, port = case
    ref_leaves = _leaves(ref["stats"])
    for backend, out in port.items():
        got = _leaves(out["stats"])
        assert [p for p, _ in got] == [p for p, _ in ref_leaves]
        for (path, a), (_, b) in zip(ref_leaves, got):
            what = f"{backend}{jax.tree_util.keystr(path)}"
            np.testing.assert_array_equal(a[..., 2], b[..., 2], err_msg=what)
            _close(b, a, compute_dtype, what)


def _dequant_caches(tree):
    """int8 caches as the values they stand for (image x hindsight scale),
    so both sides are compared on the same footing as a bf16 cache."""
    def walk(t):
        if isinstance(t, dict) and "scale" in t:
            t = dict(t)
            for j, name in enumerate(("k", "v")):
                sc = t["scale"][..., j].reshape(
                    t["scale"].shape[:-1] + (1,) * 4)
                t[name] = t[name].astype(np.float32) * sc
            return t
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t
    return walk(tree)


def test_kv_caches_match_jax(case):
    compute_dtype, _, ref, port = case
    ref_leaves = _leaves(_dequant_caches(ref["caches"]))
    for backend, out in port.items():
        got = _leaves(_dequant_caches(out["caches"]))
        assert [p for p, _ in got] == [p for p, _ in ref_leaves]
        for (path, a), (_, b) in zip(ref_leaves, got):
            what = f"{backend}{jax.tree_util.keystr(path)}"
            if "pos" in jax.tree_util.keystr(path):
                np.testing.assert_array_equal(b, a, err_msg=what)
            else:
                _close(b, a, compute_dtype, what)


def test_port_backends_agree_bitwise_on_cpu(case):
    """On the CPU the fused backend runs the kernels' plain versions, which
    repeat the simulated arithmetic exactly: the two agree bit for bit."""
    _, _, _, port = case
    sim, fus = port["simulated"], port["fused"]
    np.testing.assert_array_equal(sim["logits"], fus["logits"])
    np.testing.assert_array_equal(sim["dlogits"], fus["dlogits"])
    for (path, a), (_, b) in zip(_leaves(sim["stats"]), _leaves(fus["stats"])):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_static_path_after_state_update():
    """Fold one prefill's stats into the state; every leaf is initialized
    and the next prefill takes the single-pass branch on both backends."""
    from repro_torch.core import qlinear
    from repro_torch.core.state import tree_leaves
    cfg = tconfigs.get_reduced("starcoder2-3b")
    params = tmodel.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, 12)))
    outs = []
    for backend in ("simulated", "fused"):
        policy = TPolicy.w8a8g8(backend=backend)
        quant = tmodel.init_quant_state(cfg, policy, device="cpu")
        _, _, stats = tmodel.prefill(params, quant, {"tokens": tokens}, cfg,
                                     policy, return_stats=True)
        full = {"decoder": stats["decoder"],
                "head": qlinear.zero_stats_like(quant["head"])}
        quant = qlinear.update_quant_state(policy, quant, full)
        inited = [float(leaf[2]) for leaf in tree_leaves(quant["decoder"])]
        # Per layer 8 act leaves are visited: q (shared by k/v), o, the
        # core's q/k/v/p, mlp up and down.  k/v act leaves (the q site
        # holds the shared input range) and grad leaves stay as they were.
        assert sum(inited) == 8 * cfg.n_layers, inited
        logits, _ = tmodel.prefill(params, quant, {"tokens": tokens}, cfg,
                                   policy)
        assert torch.isfinite(logits).all()
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("extra", [[], ["--int8-cache"],
                                   ["--backend", "simulated"],
                                   ["--policy", "fp32"]],
                         ids=["fused", "int8-cache", "simulated", "fp32"])
def test_serve_main_runs_on_cpu(extra):
    run = serve.main(["--reduced", "--batch", "2", "--prompt-len", "20",
                      "--gen", "3", "--device", "cpu", *extra])
    assert run.tokens.shape == (2, 3)
    assert torch.isfinite(run.prefill_logits).all()
    assert run.prefill_logits.shape == (2, 512)
