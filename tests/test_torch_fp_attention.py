"""Port vs reference: the long-sequence fp attention paths, the attention
layer's dispatch among them, and the paper's ``grad_only`` / ``act_only``
policies, at reduced size on the CPU.

The reference is the JAX package: ``_chunked_attn`` and ``_local_attn``
run eagerly, ``attention_layer`` compiled as written
(``test_torch_conv.jit_as_written``), the ``simulated`` train step
jitted; inputs are made with numpy from a seed and parameters are the
reference's, carried across with ``repro_torch.convert``.

Tolerances, stated per test:
  * ``_chunked_attn`` / ``_local_attn`` (fp32): 2e-6 absolute + 1e-5
    relative: ``exp`` and the einsums' sums differ by ulps between XLA and
    PyTorch (observed <= 4e-7 at unit-scale inputs);
  * ``attention_layer``: the same branch on both sides, and ``y`` within
    1e-4 (the serve test's fp32 bound: an ulp of a projection may move an
    activation one 8-bit level);
  * a train step under ``grad_only`` / ``act_only``: the dense step's
    bounds (``tests/test_torch_train.py::_check_step``), and the sites of
    the quantizers the policy turns off left uninitialized, exactly as in
    the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import backend as jbackend
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import attention as jattn
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.runtime import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.core import backend as tbackend
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import attention as tattn
from repro_torch.runtime import steps as tsteps

from test_torch_conv import jit_as_written
from test_torch_train import (LR, _check_step, _jax_noise, _leaves, _np,  # noqa: F401
                              _torch_batch, jax_init)

FP_TOL = dict(rtol=1e-5, atol=2e-6)


def _qkv(b, sq, skv, nkv, g, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nkv, g, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# The fp paths against the reference functions.
# ---------------------------------------------------------------------------
CHUNKED_CASES = [
    # mode, window, prefix_len, kv_len, q_start, sq
    ("causal", None, None, None, 0, 64),
    ("causal", None, None, None, 32, 32),
    ("sliding", 16, None, None, 0, 64),
    ("sliding", 20, None, None, 32, 32),
    ("prefix", None, 20, None, 0, 64),
    ("bidir", None, None, None, 0, 64),
    ("causal", None, None, 50, 0, 64),
    ("bidir", None, None, 40, 16, 48),
]


@pytest.mark.parametrize("case", CHUNKED_CASES,
                         ids=lambda c: f"{c[0]}-q{c[4]}-kv{c[3]}")
@pytest.mark.parametrize("groups", [1, 3])
def test_chunked_attn_matches_reference(case, groups):
    mode, window, prefix_len, kv_len, q_start, sq = case
    q, k, v = _qkv(2, sq, 64, 2, groups, 16, seed=sq + groups)
    kw = dict(mode=mode, window=window, prefix_len=prefix_len,
              kv_len=kv_len, q_start=q_start, q_chunk=16, kv_chunk=8,
              scale=0.25)
    ref = np.asarray(jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    got = tattn._chunked_attn(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, ref, **FP_TOL)


@pytest.mark.parametrize("window, nblk", [(8, 4), (16, 2), (16, 1)])
@pytest.mark.parametrize("groups", [1, 3])
def test_local_attn_matches_reference(window, nblk, groups):
    """Also: the in-place form (no recorded gradient) gives the same
    values, and equals the single-tile sliding path."""
    s = window * nblk
    q, k, v = _qkv(2, s, s, 2, groups, 16, seed=s + groups)
    ref = np.asarray(jattn._local_attn(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window,
                                       scale=0.25))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn._local_attn(qt, kt, vt, window=window, scale=0.25)
    np.testing.assert_allclose(got.numpy(), ref, **FP_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tattn._local_attn(qt, kt, vt, window=window, scale=0.25), got)
    dense = tattn._dense_attn(qt, kt, vt, mode="sliding", window=window,
                              prefix_len=None, kv_len=None, scale=0.25)
    np.testing.assert_allclose(dense.numpy(), got.numpy(), **FP_TOL)


def test_local_attn_gradients_match_reference():
    """The training path past the window: d(sum(out * r))/d(q, k, v)."""
    q, k, v = _qkv(1, 32, 32, 2, 3, 16, seed=7)
    r = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn._local_attn(q, k, v, window=8, scale=0.25) * r)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn._local_attn(qt, kt, vt, window=8, scale=0.25)
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (qt, kt, vt))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# attention_layer: the same branch as the reference.
# ---------------------------------------------------------------------------
PATHS = ("_local_attn", "_dense_attn", "_chunked_attn")


def _spy_paths(monkeypatch, amod, bmod, calls):
    for name in PATHS:
        orig = getattr(amod, name)

        def wrapped(*a, _n=name, _o=orig, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(amod, name, wrapped)
    orig_core = bmod.qattention

    def core(*a, **k):
        calls.append("qattention")
        return orig_core(*a, **k)
    monkeypatch.setattr(bmod, "qattention", core)


POLICIES = {
    "static": (lambda: JPolicy.w8a8g8(backend="simulated"),
               lambda: TPolicy.w8a8g8(backend="fused")),
    "fp32": (JPolicy.disabled, TPolicy.disabled),
    "grad_only": (lambda: JPolicy.grad_only("hindsight"),
                  lambda: TPolicy.grad_only("hindsight")),
}
LAYER_CASES = [
    # mode, S, window, dense_attn_max, the branch expected off the core
    ("sliding", 8, 16, 4096, "_dense_attn"),       # S below the window
    ("sliding", 32, 16, 4096, "_local_attn"),      # S past it
    ("sliding", 24, 16, 16, "_chunked_attn"),      # not a multiple, long
    ("causal", 32, None, 4096, "_dense_attn"),
    ("causal", 32, None, 16, "_chunked_attn"),     # past dense_attn_max
]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-max{c[3]}")
@pytest.mark.parametrize("pol", list(POLICIES))
def test_attention_layer_takes_the_reference_branch(pol, case, monkeypatch):
    mode, s, window, dmax, fp_branch = case
    d, nh, nkv, hd = 32, 4, 2, 16
    params = _np(jattn.init_attention(jax.random.PRNGKey(3), d, nh, nkv, hd,
                                      use_bias=True))
    sites = _np(jattn.init_attention_sites())
    x = np.random.default_rng(s).standard_normal((2, s, d)).astype(
        np.float32)
    jpol, tpol = (f() for f in POLICIES[pol])
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, mode=mode, window=window,
              q_chunk=8, kv_chunk=8, dense_attn_max=dmax)
    jcalls, tcalls = [], []
    _spy_paths(monkeypatch, jattn, jbackend, jcalls)
    _spy_paths(monkeypatch, tattn, tbackend, tcalls)
    yj, _, _ = jit_as_written(
        lambda p, st, xx, sd, sp: jattn.attention_layer(
            p, st, xx, policy=jpol, seed=sd, step=sp, **kw),
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, sites), jnp.asarray(x),
        jnp.int32(0), jnp.int32(0))
    yt, _, _ = tattn.attention_layer(
        {k_: torch.from_numpy(v_) for k_, v_ in params.items()},
        jax.tree_util.tree_map(torch.from_numpy, sites), torch.from_numpy(x),
        policy=tpol, seed=0, step=0, **kw)
    assert tcalls == jcalls == (["qattention"] if pol == "static"
                                else [fp_branch])
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The paper's policies.
# ---------------------------------------------------------------------------
def _policy_fields(p):
    spec = lambda s: (s.bits, s.symmetric, s.stochastic)  # noqa: E731
    est = lambda e: (e.kind, e.momentum)                  # noqa: E731
    return dict(enabled=p.enabled, quantize_weights=p.quantize_weights,
                quantize_acts=p.quantize_acts,
                quantize_grads=p.quantize_grads,
                int8_weight_gather=p.int8_weight_gather,
                weight_spec=spec(p.weight_spec), act_spec=spec(p.act_spec),
                grad_spec=spec(p.grad_spec),
                act_estimator=est(p.act_estimator),
                grad_estimator=est(p.grad_estimator), backend=p.backend,
                stat_width=p.stat_width,
                is_fully_static=p.is_fully_static)


@pytest.mark.parametrize("kind", ["current", "running", "hindsight", "dsgc",
                                  "fixed"])
@pytest.mark.parametrize("ctor", ["grad_only", "act_only"])
def test_paper_policies_match_reference_field_by_field(ctor, kind):
    jp = getattr(JPolicy, ctor)(kind, momentum=0.8)
    tp = getattr(TPolicy, ctor)(kind, momentum=0.8)
    assert _policy_fields(tp) == _policy_fields(jp)
    assert [f.name for f in dataclasses.fields(tp)] == \
        [f.name for f in dataclasses.fields(jp)]


# The sites each policy turns off: activation sites (and the attention
# core's) under grad_only, gradient sites under act_only.  The k/v act
# leaves are never visited (q/k/v share one input site).
def _off(name, ctor):
    if ctor == "grad_only":
        return "'grad'" not in name
    return "'grad'" in name


@pytest.mark.parametrize("ctor", ["grad_only", "act_only"])
def test_train_step_under_paper_policy_matches_jax(ctor, jax_init):
    """One step of the reduced LM (S 32 past its window of 16: the
    grad_only forward takes ``_local_attn``), the JAX simulated backend
    against both port backends that ``backend.validate`` admits (the
    policy is static), the reference's noise patched in."""
    init, batches = jax_init
    cfg_j = dataclasses.replace(jconfigs.get_reduced("starcoder2-3b"),
                                compute_dtype="bfloat16")
    cfg_t = dataclasses.replace(tconfigs.get_reduced("starcoder2-3b"),
                                compute_dtype="bfloat16")
    step_j = jax.jit(jsteps.make_train_step(
        cfg_j, getattr(JPolicy, ctor)("hindsight"), jadamw(weight_decay=0.0),
        jsched.constant(LR)))
    state, met = step_j(jax.tree_util.tree_map(jnp.asarray, init),
                        batches[0])
    s = _np(state)
    ref = (float(met["loss"]), s["quant"], s["params"])
    # the turned-off sites that start uninitialized (the attention core's
    # p-site starts on [0, 1]) stay so; every other site is initialized
    fresh = {jax.tree_util.keystr(p) for p, leaf in _leaves(init["quant"])
             if leaf[..., 2].max() == 0.0}
    off = {n for n in fresh if _off(n, ctor)}
    assert off and all(
        (leaf[..., 2].max() == 0.0) == (jax.tree_util.keystr(p) in off)
        for p, leaf in _leaves(ref[1])
        if jax.tree_util.keystr(p) in fresh
        and "['k']['act']" not in jax.tree_util.keystr(p)
        and "['v']['act']" not in jax.tree_util.keystr(p))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbackend, "site_noise", _jax_noise)
        for bk in ("simulated", "fused"):
            pol = dataclasses.replace(getattr(TPolicy, ctor)("hindsight"),
                                      backend=bk)
            opt = topt.adamw(weight_decay=0.0)
            st = convert.train_state_from_jax(init, cfg_t, opt, "cpu")
            step = tsteps.make_train_step(cfg_t, pol, opt,
                                          topt.constant(LR))
            st, met_t = step(st, _torch_batch(batches[0]))
            got = (float(met_t["loss"]),
                   convert.to_jax_layout(st["quant"], cfg_t),
                   convert.params_to_jax(st["params"], cfg_t))
            _check_step(ref, got, (bk, 0))
            for p, leaf in _leaves(got[1]):
                if jax.tree_util.keystr(p) in off:
                    assert leaf[..., 2].max() == 0.0, (bk, p)
