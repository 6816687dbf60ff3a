"""Port vs reference: the RG-LRU recurrent block (``repro_torch.models
.rglru``) on the CPU, at reduced widths.

The reference is ``repro.models.rglru``; parameters are its
``init_rglru`` carried across as numpy, inputs are made with numpy from a
seed.  Tolerances, stated per test:
  * ``rglru_scan``: bit-equal to ``jax.lax.associative_scan`` run op by op
    (``jax.disable_jit``) and to the reference compiled as written
    (``test_torch_conv.jit_as_written``); within 4 ulps of max |h| of the
    plainly jitted scan, where LLVM contracts ``a2 * b1 + b2`` into an FMA
    (observed 2);
  * ``_causal_conv1d``: bit-equal op by op, output and tail, fp32 and bf16;
  * ``apply_rglru``, op by op: XLA's CPU ``logistic``, ``exp``, ``log1p``,
    ``sqrt`` and ``tanh`` are approximations of its own, a few ulps from
    PyTorch's (``test_torch_transcendentals_within_four_ulps_of_xla``).  Fed those
    (``xla_math``), the port's output, state, integer images and every
    site's statistics are bit-equal to the reference's, hindsight and fp32,
    prefill and decode.  Without them, in bf16 compute (the configs'
    compute dtype) the output, the integer images and the statistics are
    still bit-equal and ``h`` within 4 ulps of max |h|; in fp32 compute
    ``y`` within 1e-6 and the sites before the gates (``in``/``gate``,
    ``a``/``x``) bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import rglru as jrglru
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import rglru as trglru

from test_torch_conv import jit_as_written

D, C = 64, 64
_XLA_MATH = {"sigmoid": jax.nn.sigmoid, "exp": jnp.exp, "log1p": jnp.log1p,
             "sqrt": jnp.sqrt, "tanh": jnp.tanh}


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.array(a), tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _in_dtype(x, dtype):
    """``x`` rounded to ``dtype`` (as float32 numpy)."""
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


@pytest.fixture
def xla_math(monkeypatch):
    """The port's fp32 transcendentals computed by XLA (the reference's
    own approximations); other dtypes keep PyTorch's."""
    for name, fn in _XLA_MATH.items():
        orig = getattr(torch, name)

        def patched(t, *a, _f=fn, _o=orig, **k):
            if t.dtype != torch.float32:
                return _o(t, *a, **k)
            return torch.from_numpy(np.array(_f(jnp.asarray(
                t.detach().numpy()))))
        monkeypatch.setattr(torch, name, patched)


def _scan_inputs(s, h0, seed=0):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, s, 16))))).astype(
        np.float32)
    b = rng.standard_normal((2, s, 16)).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32) if h0 else None
    return a, b, h


def _port_scan(a, b, h):
    return trglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                             None if h is None else torch.from_numpy(h)
                             ).numpy()


def _jax_args(a, b, h):
    return (jnp.asarray(a), jnp.asarray(b)) + (
        () if h is None else (jnp.asarray(h),))


# ---------------------------------------------------------------------------
# The scan.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("s", [1, 2, 3, 8, 13, 64, 257])
def test_rglru_scan_bit_equal_to_associative_scan_op_by_op(s, h0):
    a, b, h = _scan_inputs(s, h0)
    with jax.disable_jit():
        ref = np.asarray(jrglru.rglru_scan(*_jax_args(a, b, h)))
    got = _port_scan(a, b, h)
    assert got.shape == (2, s, 16)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("s", [2, 13, 2048])
def test_rglru_scan_against_the_jitted_scan(s, h0):
    """Compiled as written the reference equals the port bit for bit;
    plainly jitted it differs by an FMA's rounding, within 4 ulps of
    max |h|."""
    a, b, h = _scan_inputs(s, h0, seed=1)
    args = _jax_args(a, b, h)
    got = _port_scan(a, b, h)
    np.testing.assert_array_equal(
        got, np.asarray(jit_as_written(jrglru.rglru_scan, *args)))
    ref = np.asarray(jax.jit(jrglru.rglru_scan)(*args))
    assert np.abs(got - ref).max() <= 4 * np.spacing(np.abs(ref).max())


def test_rglru_scan_matches_sequential_loop():
    """The reference's ``tests/test_models.py::
    test_rglru_scan_matches_loop`` on the port: each h_t against the loop
    ``h = a_t h + b_t`` within rtol 1e-5, atol 1e-6."""
    a, b, h = _scan_inputs(12, True, seed=2)
    hs = _port_scan(a, b, h)
    run = h
    for i in range(a.shape[1]):
        run = a[:, i] * run + b[:, i]
        np.testing.assert_allclose(hs[:, i], run, rtol=1e-5, atol=1e-6)


def test_rglru_scan_gradients_match_jax():
    """Autograd through the recursion (the train step's backward) against
    ``jax.vjp`` of the reference's scan: within 1e-5 relative to each
    gradient's largest element (sums in another order)."""
    a, b, h = _scan_inputs(37, True, seed=3)
    g = np.random.default_rng(4).standard_normal(a.shape).astype(np.float32)
    _, vjp = jax.vjp(jrglru.rglru_scan, *_jax_args(a, b, h))
    ref = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, b, h)]
    got = torch.autograd.grad(trglru.rglru_scan(*ts), ts,
                              torch.from_numpy(g))
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


# ---------------------------------------------------------------------------
# The conv and the transcendentals.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tail", [False, True], ids=["no-tail", "tail"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype, tail):
    rng = np.random.default_rng(5)
    x = _in_dtype(rng.standard_normal((2, 9, C)), dtype)
    w = (rng.standard_normal((4, C)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    t = _in_dtype(rng.standard_normal((2, 3, C)), dtype) if tail else None
    with jax.disable_jit():
        yj, tj = jrglru._causal_conv1d(
            jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(bias),
            None if t is None else jnp.asarray(t, dtype))
    tdt = getattr(torch, dtype)
    yt, tt = trglru._causal_conv1d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w),
        torch.from_numpy(bias),
        None if t is None else torch.from_numpy(t).to(tdt))
    assert yt.dtype == tt.dtype == tdt and tt.shape == (2, 3, C)
    np.testing.assert_array_equal(yt.float().numpy(), _np(yj))
    np.testing.assert_array_equal(tt.float().numpy(), _np(tj))
    if tail:      # the carried context shifts into the first outputs
        np.testing.assert_array_equal(tt.float().numpy(), x[:, -3:])


def test_softplus_is_logaddexp(xla_math):
    """The port's ``softplus`` writes ``jnp.logaddexp(x, 0)``'s ops (no
    threshold): fed XLA's ``exp`` and ``log1p``, bit-equal to
    ``jax.nn.softplus`` on the init's ``lambda`` and on wide inputs."""
    lam = np.asarray(jrglru.init_rglru(jax.random.PRNGKey(0), D, 4096)
                     ["lambda"])
    wide = (np.random.default_rng(6).standard_normal(4096) * 30).astype(
        np.float32)
    for x in (lam, wide):
        np.testing.assert_array_equal(
            trglru._softplus(torch.from_numpy(x)).numpy(),
            np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(_XLA_MATH))
def test_torch_transcendentals_within_four_ulps_of_xla(name):
    """What separates the port's fp32 gates from the reference's: XLA's
    CPU approximations, each within 4 ulps of PyTorch's (observed: log1p
    3, tanh 4 where XLA saturates to 1 past |x| ~ 7.9)."""
    x = (np.random.default_rng(7).standard_normal(65536) * 4).astype(
        np.float32)
    if name in ("sqrt", "log1p"):
        x = np.abs(x)
    ref = np.asarray(_XLA_MATH[name](jnp.asarray(x)))
    got = getattr(torch, name)(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - ref) <= 4 * np.spacing(np.abs(ref)))
    if name != "sigmoid":
        assert np.mean(got != ref) > 1e-3     # the residual exists


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------
B, S = 2, 33


def _layer_inputs(dtype, decode, seed=0):
    params = _np(jrglru.init_rglru(jax.random.PRNGKey(1), D, C))
    rng = np.random.default_rng(seed)
    params["b_a"] = (rng.standard_normal(C) * 0.5).astype(np.float32)
    params["b_x"] = (rng.standard_normal(C) * 0.5).astype(np.float32)
    params["conv_b"] = (rng.standard_normal(C) * 0.1).astype(np.float32)
    x = _in_dtype(rng.standard_normal((B, 1 if decode else S, D)), dtype)
    state = None
    if decode:
        state = (rng.standard_normal((B, C)).astype(np.float32),
                 _in_dtype(rng.standard_normal((B, 3, C)), dtype))
    return params, x, state


def _initialized(stats):
    return jax.tree_util.tree_map(
        lambda s: np.asarray([s[0], s[1], 1.0], np.float32) if s[2] > 0.5
        else np.zeros(3, np.float32), stats)


def _run_layer(mp, params, sites, x, state, dtype, policy):
    """The reference op by op, and the port on both backends.  Returns per
    side ``(y, stats, h, tail, images)``."""
    images = {"j": [], "t": []}
    for side, mod in (("j", jqlinear), ("t", tqlinear)):
        orig = mod.act_quant_site

        def spy(*a, _o=orig, _s=side, **k):
            out = _o(*a, **k)
            if out[2] is not None:
                images[_s].append(np.asarray(out[2].q))
            return out
        mp.setattr(mod, "act_quant_site", spy)
    jpol = JPolicy.disabled() if policy == "fp32" else \
        JPolicy.w8a8g8(backend="simulated")
    with jax.disable_jit():
        y, st, (h, tail) = jrglru.apply_rglru(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, sites),
            jnp.asarray(x, dtype), policy=jpol, seed=jnp.int32(3),
            step=jnp.int32(0),
            state=None if state is None else (
                jnp.asarray(state[0]), jnp.asarray(state[1], dtype)))
    out = {"ref": (_np(y), _np(st), np.asarray(h), _np(tail),
                   images["j"])}
    tdt = getattr(torch, dtype)
    for bk in ("simulated", "fused"):
        images["t"] = []
        tpol = TPolicy.disabled() if policy == "fp32" else \
            TPolicy.w8a8g8(backend=bk)
        y, st, (h, tail) = trglru.apply_rglru(
            _t(params), _t(sites), torch.from_numpy(x).to(tdt), policy=tpol,
            seed=3, step=0,
            state=None if state is None else (
                torch.from_numpy(state[0]),
                torch.from_numpy(state[1]).to(tdt)))
        assert y.dtype == tail.dtype == tdt and h.dtype == torch.float32
        out[bk] = (y.float().numpy(),
                   jax.tree_util.tree_map(lambda v: v.numpy(), st),
                   h.numpy(), tail.float().numpy(), images["t"])
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


LAYER_CASES = [(p, d, m) for p in ("hindsight", "fp32")
               for d in ("float32", "bfloat16")
               for m in ("prefill", "decode", "initialized")
               if not (p == "fp32" and m == "initialized")]


def _layer_case(policy, dtype, mode, mp):
    params, x, state = _layer_inputs(dtype, mode == "decode")
    sites = _np(jrglru.init_rglru_sites())
    if mode == "initialized":     # the static single-pass branch
        first = _run_layer(mp, params, sites, x, state, dtype, policy)
        sites = _initialized(first["ref"][1])
    return _run_layer(mp, params, sites, x, state, dtype, policy)


@pytest.mark.parametrize("policy,dtype,mode", LAYER_CASES,
                         ids=["-".join(c) for c in LAYER_CASES])
def test_apply_rglru_bit_equal_op_by_op(policy, dtype, mode, xla_math,
                                        monkeypatch):
    """Fed XLA's transcendentals: y, h, the conv tail, the five sites'
    integer images (``in``/``gate`` shared, ``a``/``x`` shared, ``out``)
    and statistics bit-equal to the reference's op-by-op run."""
    out = _layer_case(policy, dtype, mode, monkeypatch)
    y_r, st_r, h_r, tail_r, img_r = out["ref"]
    assert len(img_r) == (0 if policy == "fp32" else 3)
    for bk in ("simulated", "fused"):
        y_t, st_t, h_t, tail_t, img_t = out[bk]
        np.testing.assert_array_equal(y_t, y_r, f"{bk} y")
        np.testing.assert_array_equal(h_t, h_r, f"{bk} h")
        np.testing.assert_array_equal(tail_t, tail_r, f"{bk} tail")
        assert len(img_t) == len(img_r)
        for i, (a, b) in enumerate(zip(img_r, img_t)):
            np.testing.assert_array_equal(a, b, f"{bk} image {i}")
        lr, lt = _leaves(st_r), _leaves(st_t)
        assert [p for p, _ in lr] == [p for p, _ in lt]
        assert {jax.tree_util.keystr(p)[2:].split("'")[0] for p, _ in lr} \
            == {"in", "gate", "out", "a", "x"}
        for (path, a), (_, b) in zip(lr, lt):
            np.testing.assert_array_equal(
                a, b, f"{bk}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_rglru_with_torch_transcendentals(dtype, mode, monkeypatch):
    """PyTorch's own fp32 ``sigmoid``/``exp``/``log1p``/``sqrt``/``tanh``
    (as on the card): the sites ahead of the gates are bit-equal, ``h``
    within 4 ulps of max |h|; in bf16 compute the output, every image and
    every statistic stay bit-equal, in fp32 ``y`` is within 1e-6."""
    out = _layer_case("hindsight", dtype, mode, monkeypatch)
    y_r, st_r, h_r, _, img_r = out["ref"]
    for bk in ("simulated", "fused"):
        y_t, st_t, h_t, _, img_t = out[bk]
        assert np.abs(h_t - h_r).max() <= 4 * np.spacing(np.abs(h_r).max())
        for i in (0, 1):          # the in/gate and a/x images
            np.testing.assert_array_equal(img_r[i], img_t[i])
        for name in ("in", "gate", "a", "x"):
            np.testing.assert_array_equal(st_t[name]["act"],
                                          st_r[name]["act"], name)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(y_t, y_r)
            np.testing.assert_array_equal(img_t[2], img_r[2])
            np.testing.assert_array_equal(st_t["out"]["act"],
                                          st_r["out"]["act"])
        else:
            np.testing.assert_allclose(y_t, y_r, rtol=0, atol=1e-6)


def test_init_rglru_matches_reference_shapes_and_dtypes():
    ref = jrglru.init_rglru(jax.random.PRNGKey(0), D, C)
    gen = torch.Generator().manual_seed(0)
    got = trglru.init_rglru(gen, D, C)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    # lambda: the inverse softplus of -log(u)/8, u in (0.9^2, 0.999^2)
    u = np.exp(-8 * np.log1p(np.exp(got["lambda"].double().numpy())))
    assert np.all((u > 0.81 - 1e-6) & (u < 0.998001 + 1e-6))
    assert set(trglru.init_rglru_sites()) == set(jrglru.init_rglru_sites())
