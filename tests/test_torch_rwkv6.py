"""Port vs reference: the RWKV-6 block (``repro_torch.models.rwkv6``) on the
CPU, at reduced widths.

The reference is ``repro.models.rwkv6``; parameters are its inits carried
across as numpy, with ``u``, ``mu``, ``mu_x``, ``w0``, ``ln_x_scale`` and
``ln_x_bias`` (and the channel mix's ``mu_k``, ``mu_r``) perturbed from a
seed: at the init's constants (``u = 0``, all mixes 0.5, ``w0 = -6``) a
missing bonus, a swapped branch or a flat decay would go unseen.  Inputs
are made with numpy from a seed.

Tolerances, stated per test:
  * fed XLA's own primitives (``xla_prims``: the reference's fp32
    ``einsum``, ``cumsum``, ``sum``, ``exp``, ``tanh``, ``sigmoid`` and
    ``rsqrt``, in the port's rwkv6 module only, and the decay tile's
    contraction as XLA's dot), every function is
    bit-equal to the reference run op by op: ``wkv_chunked`` (y and state,
    every chunk length and ragged tail), ``wkv_step``, ``_ddlerp``,
    ``_group_norm``, and both mixes' outputs, carried state, integer
    images and site statistics, hindsight and fp32, prefill and decode,
    on both backends.  One exception: under ``QuantPolicy.disabled()`` in
    fp32 compute the projections are fp32 products (in ``core``, not fed
    XLA's), so output and state agree within 1e-5 of their largest
    elements there;
  * with PyTorch's own primitives (as on the card): ``wkv_chunked``
    within 1e-6 of max |y| and max |S| (observed 2.2e-7 and 3.2e-7: the
    products and XLA's associative ``cumsum`` sum in other orders); the
    bf16 ``_ddlerp`` within one bf16 ulp in at most 0.1% of the elements;
    ``_group_norm`` and the decay tile's contraction within 4 ulps of
    their largest elements;
  * the backward: the gradient sites' statistics within 1e-5 of each
    leaf's largest element (the time mix's ``o``, whose cotangent is the
    upstream one, bit for bit), the input's gradient within 1e-3 of its
    largest element;
  * chunk invariance: chunks of 4, 8 and the whole sequence, and the
    token-by-token ``wkv_step``, within 1e-5 of max |y|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import rwkv6 as jrwkv
from repro_torch.core import backend as tbackend
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import rwkv6 as trwkv

D, H, FF = 64, 4, 128
HD = D // H


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.array(a), tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _in_dtype(x, dtype):
    """``x`` rounded to ``dtype`` (as float32 numpy)."""
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


class _XlaTorch:
    """``torch`` for the port's rwkv6 module, with its fp32 primitives
    computed by XLA (the reference's own): ``einsum`` (XLA's dot, whose
    summation order is Eigen's), ``cumsum`` (an associative scan on the
    CPU), ``sum`` (a sequential reduce), ``exp``, ``tanh``, ``sigmoid``
    and ``rsqrt`` (XLA's approximations).  Everything else is PyTorch's."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def _xla(fn, *tensors, **kw):
        if any(t.dtype != torch.float32 for t in tensors):
            return None
        out = fn(*(jnp.asarray(t.detach().numpy()) for t in tensors), **kw)
        return torch.from_numpy(np.array(out))

    def einsum(self, spec, *ops):
        out = self._xla(lambda *a: jnp.einsum(
            spec, *a, preferred_element_type=jnp.float32), *ops)
        return torch.einsum(spec, *ops) if out is None else out

    def cumsum(self, t, dim):
        return self._xla(lambda a: jnp.cumsum(a, axis=dim), t)

    def sum(self, t, dim, keepdim=False):
        return self._xla(lambda a: jnp.sum(a, axis=dim, keepdims=keepdim), t)

    def exp(self, t):
        return self._xla(jnp.exp, t)

    def tanh(self, t):
        return self._xla(jnp.tanh, t)

    def sigmoid(self, t):
        return self._xla(jax.nn.sigmoid, t)

    def rsqrt(self, t):
        return self._xla(jax.lax.rsqrt, t)


def _xla_decay_products(r, k, expd):
    """The reference's einsum as XLA computes it (a dot over ``d``)."""
    return torch.from_numpy(np.array(jnp.einsum(
        "...td,...id,...tid->...ti",
        *(jnp.asarray(t.detach().numpy()) for t in (r, k, expd)),
        preferred_element_type=jnp.float32)))


@pytest.fixture
def xla_prims(monkeypatch):
    monkeypatch.setattr(trwkv, "torch", _XlaTorch())
    monkeypatch.setattr(trwkv, "_decay_products", _xla_decay_products)


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


# ---------------------------------------------------------------------------
# The WKV core.
# ---------------------------------------------------------------------------
def _wkv_inputs(t, seed=0, b=2, logw=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, H, t, HD)).astype(np.float32)
               for _ in range(3))
    if logw is None:
        lw = -np.exp(rng.standard_normal((b, H, t, HD)) * 0.5 - 1.0)
    else:
        lw = np.full((b, H, t, HD), logw)
    u = rng.standard_normal((H, HD)).astype(np.float32)
    s = rng.standard_normal((b, H, HD, HD)).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u, s


def _ref_wkv(args, chunk):
    with jax.disable_jit():
        y, s = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    return np.asarray(y), np.asarray(s)


def _port_wkv(args, chunk):
    with torch.no_grad():
        y, s = trwkv.wkv_chunked(*map(torch.from_numpy, args), chunk=chunk)
    return y.numpy(), s.numpy()


WKV_CASES = [(c, t) for c in (8, 4) for t in (5, 16, 19)]


@pytest.mark.parametrize("chunk,t", WKV_CASES,
                         ids=[f"c{c}-t{t}" for c, t in WKV_CASES])
def test_wkv_chunked_bit_equal_with_xla_primitives(chunk, t, xla_prims):
    """T below the chunk, a multiple of it and a ragged tail (19 = 2 x 8
    + 3, 4 x 4 + 3), from a nonzero state with a nonzero bonus ``u``."""
    args = _wkv_inputs(t)
    yr, sr = _ref_wkv(args, chunk)
    yt, st = _port_wkv(args, chunk)
    assert yt.shape == (2, H, t, HD) and st.shape == (2, H, HD, HD)
    np.testing.assert_array_equal(yt, yr)
    np.testing.assert_array_equal(st, sr)


@pytest.mark.parametrize("chunk,t", WKV_CASES,
                         ids=[f"c{c}-t{t}" for c, t in WKV_CASES])
def test_wkv_chunked_with_torch_primitives(chunk, t):
    args = _wkv_inputs(t, seed=1)
    yr, sr = _ref_wkv(args, chunk)
    yt, st = _port_wkv(args, chunk)
    assert np.abs(yt - yr).max() <= 1e-6 * np.abs(yr).max()
    assert np.abs(st - sr).max() <= 1e-6 * np.abs(sr).max()


def test_decay_products_match_the_reference_einsum():
    """The port's product-then-sum form of ``einsum("bhtd,bhid,bhtid->
    bhti")``: the same products in the same order, summed over ``d`` in
    another order than XLA's dot, within 4 ulps of max |A| (observed
    1)."""
    rng = np.random.default_rng(8)
    r, k = (rng.standard_normal((2, H, 8, HD)).astype(np.float32)
            for _ in range(2))
    e = rng.random((2, H, 8, 8, HD)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jnp.einsum("bhtd,bhid,bhtid->bhti",
                                    *map(jnp.asarray, (r, k, e)),
                                    preferred_element_type=jnp.float32))
    got = trwkv._decay_products(*map(torch.from_numpy, (r, k, e))).numpy()
    assert np.abs(got - ref).max() <= 4 * np.spacing(np.abs(ref).max())


def test_wkv_chunked_in_groups_of_chunks(monkeypatch, xla_prims):
    """The state-independent terms computed two chunks at a time (a
    decay-tile budget of two chunks), 43 = 10 x 4 + 3: fed XLA's
    primitives, bit-equal to the reference's one chunk at a time."""
    args = _wkv_inputs(43, seed=2)
    monkeypatch.setattr(trwkv, "_TILE_BYTES", 2 * 2 * H * 4 * 4 * HD * 4)
    for a, b in zip(_ref_wkv(args, 4), _port_wkv(args, 4)):
        np.testing.assert_array_equal(b, a)


def _token_by_token(args):
    r, k, v, lw, u, s = map(torch.from_numpy, args)
    ys = []
    for i in range(r.shape[2]):
        y, s = trwkv.wkv_step(r[:, :, i], k[:, :, i], v[:, :, i],
                              lw[:, :, i], u, s)
        ys.append(y)
    return torch.stack(ys, dim=2).numpy(), s.numpy()


def test_wkv_chunk_invariance_and_step():
    """Chunks of 4, 8 and 64 (one chunk: T = 37 < 64) and the decode
    recurrence token by token agree within 1e-5 of max |y| and max |S|."""
    args = _wkv_inputs(37, seed=3)
    ref_y, ref_s = _token_by_token(args)
    for chunk in (4, 8, 64):
        y, s = _port_wkv(args, chunk)
        assert np.abs(y - ref_y).max() <= 1e-5 * np.abs(ref_y).max(), chunk
        assert np.abs(s - ref_s).max() <= 1e-5 * np.abs(ref_s).max(), chunk


def test_wkv_step_bit_equal_with_xla_primitives(xla_prims):
    r, k, v, lw, u, s = _wkv_inputs(1, seed=4)
    args = (r[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0], u, s)
    with jax.disable_jit():
        yr, sr = jrwkv.wkv_step(*map(jnp.asarray, args))
    yt, st = trwkv.wkv_step(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))


def test_strong_decay_forward_equal_and_gradient_finite_where_reference():
    """``logw = -8`` a token, chunk 16: above the diagonal the decay tile's
    exponents reach +120 and ``exp`` overflows to inf; the forward masks
    them (finite, within 1e-6 of max |y| of the reference), but the
    backward multiplies the mask's zero cotangent by inf.  The port
    mirrors the reference's arithmetic, so its gradients are NaN exactly
    where the reference's are (rows 0-4 of each chunk for r, 11-15 for k,
    all of logw); at ``logw = -1`` both are finite everywhere."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((1, H, 32, HD)).astype(np.float32)
    for lw, finite in ((-8.0, False), (-1.0, True)):
        args = _wkv_inputs(32, seed=6, b=1, logw=lw)
        yr, vjp = jax.vjp(lambda *a: jrwkv.wkv_chunked(*a, chunk=16)[0],
                          *map(jnp.asarray, args))
        gr = [np.asarray(x) for x in vjp(jnp.asarray(g))]
        ts = [torch.from_numpy(x).requires_grad_() for x in args]
        yt, _ = trwkv.wkv_chunked(*ts, chunk=16)
        gt = torch.autograd.grad(yt, ts, torch.from_numpy(g))
        yr = np.asarray(yr)
        assert np.isfinite(yr).all() and torch.isfinite(yt).all()
        assert np.abs(yt.detach().numpy() - yr).max() <= \
            1e-6 * np.abs(yr).max()
        for name, a, b in zip(("r", "k", "v", "logw", "u", "state"), gr, gt):
            np.testing.assert_array_equal(np.isfinite(b.numpy()),
                                          np.isfinite(a), f"{lw} {name}")
        assert all(np.isfinite(a).all() for a in gr) == finite


def test_strong_decay_gradient_pattern():
    """Where the NaNs are at ``logw = -8``, chunk 16: the masked entries
    with ``8 (i - t + 1) > 88.7`` overflow, so rows 0-4 of each chunk for
    ``r``, rows 11-15 for ``k``, every ``logw``; ``v``, ``u`` and the
    state stay finite."""
    args = _wkv_inputs(32, seed=6, b=1, logw=-8.0)
    ts = [torch.from_numpy(x).requires_grad_() for x in args]
    yt, _ = trwkv.wkv_chunked(*ts, chunk=16)
    gt = torch.autograd.grad(yt.sum(), ts)
    rows = np.arange(32) % 16
    bad_r = ~torch.isfinite(gt[0]).all(dim=-1)[0, 0].numpy()
    bad_k = ~torch.isfinite(gt[1]).all(dim=-1)[0, 0].numpy()
    np.testing.assert_array_equal(bad_r, rows <= 4)
    np.testing.assert_array_equal(bad_k, rows >= 11)
    assert not torch.isfinite(gt[3]).any()
    assert torch.isfinite(gt[2]).all() and torch.isfinite(gt[5]).all()


# ---------------------------------------------------------------------------
# The token-shift mix and the group norm.
# ---------------------------------------------------------------------------
def _time_params(seed=0):
    p = _np(jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(seed), D, H))
    rng = np.random.default_rng(100 + seed)
    p["mu_x"] = rng.uniform(0, 1, D).astype(np.float32)
    p["mu"] = rng.uniform(0, 1, (5, D)).astype(np.float32)
    p["u"] = rng.standard_normal((H, HD)).astype(np.float32)
    p["w0"] = rng.uniform(-4.0, -0.5, D).astype(np.float32)
    p["ln_x_scale"] = (1 + 0.3 * rng.standard_normal(D)).astype(np.float32)
    p["ln_x_bias"] = (0.3 * rng.standard_normal(D)).astype(np.float32)
    return p


def _chan_params(seed=0):
    p = _np(jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(seed), D, FF))
    rng = np.random.default_rng(200 + seed)
    p["mu_k"] = rng.uniform(0, 1, D).astype(np.float32)
    p["mu_r"] = rng.uniform(0, 1, D).astype(np.float32)
    return p


def _ddlerp_pair(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = _in_dtype(rng.standard_normal((2, 33, D)), dtype)
    xp = _in_dtype(rng.standard_normal((2, 33, D)), dtype)
    p = _time_params()
    with jax.disable_jit():
        ref = jrwkv._ddlerp(jnp.asarray(x, dtype), jnp.asarray(xp, dtype),
                            jax.tree_util.tree_map(jnp.asarray, p))
    tdt = getattr(torch, dtype)
    got = trwkv._ddlerp(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(xp).to(tdt), _t(p))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_bf16_bit_equal_with_xla_primitives(dtype, xla_prims):
    """The five mixes are rounded to bf16 whatever the compute dtype (an
    fp32-compute run still carries bf16 mixes), bit-equal."""
    ref, got = _ddlerp_pair(dtype)
    assert got.shape == (2, 33, 5, D)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_with_torch_primitives(dtype):
    """PyTorch's ``tanh`` and products: one bf16 ulp in at most 0.1% of
    the elements (observed 9 of 21120), none further."""
    ref, got = _ddlerp_pair(dtype)
    d = np.abs(got - ref)
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2 ** 16
    assert np.all(d <= ulp)
    assert np.mean(d > 0) <= 1e-3


def test_group_norm(xla_prims):
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 33, D)) * 3).astype(np.float32)
    sc, bi = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    with jax.disable_jit():
        ref = np.asarray(jrwkv._group_norm(*map(jnp.asarray, (y, sc, bi)),
                                           H))
    got = trwkv._group_norm(*map(torch.from_numpy, (y, sc, bi)), H).numpy()
    np.testing.assert_array_equal(got, ref)


def test_group_norm_with_torch_primitives():
    """PyTorch's vectorized sums and ``rsqrt`` (XLA sums a row in order,
    and its ``rsqrt`` is an approximation of its own): within 4 ulps of
    max |out| (observed 9.5e-7 at max ~7)."""
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 33, D)) * 3).astype(np.float32)
    sc, bi = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    ref = np.asarray(jrwkv._group_norm(*map(jnp.asarray, (y, sc, bi)), H))
    got = trwkv._group_norm(*map(torch.from_numpy, (y, sc, bi)), H).numpy()
    assert np.abs(got - ref).max() <= 4 * np.spacing(np.abs(ref).max())


# ---------------------------------------------------------------------------
# The two mixes.
# ---------------------------------------------------------------------------
B, S, CHUNK = 2, 19, 8


def _spy_images(mp, images):
    for side, mod in (("j", jqlinear), ("t", tqlinear)):
        orig = mod.act_quant_site

        def spy(*a, _o=orig, _s=side, **k):
            out = _o(*a, **k)
            if out[2] is not None:
                images[_s].append(np.asarray(out[2].q))
            return out
        mp.setattr(mod, "act_quant_site", spy)


def _initialized(stats):
    return jax.tree_util.tree_map(
        lambda s: np.asarray([s[0], s[1], 1.0], np.float32) if s[2] > 0.5
        else np.zeros(3, np.float32), stats)


def _mix_inputs(which, dtype, decode, seed=0):
    rng = np.random.default_rng(300 + seed)
    s = 1 if decode else S
    x = _in_dtype(rng.standard_normal((B, s, D)), dtype)
    xp = _in_dtype(rng.standard_normal((B, D)), dtype) if decode else None
    if which == "time":
        st = (rng.standard_normal((B, H, HD, HD)) * 0.5).astype(np.float32) \
            if decode else None
        return _time_params(seed), x, xp, st
    return _chan_params(seed), x, xp, None


def _call(side, which, params, sites, x, xp, st, dtype, policy, bk=None):
    """One mix on one side; returns ``(y, stats, carried)`` as numpy."""
    if side == "j":
        pol = JPolicy.disabled() if policy == "fp32" else \
            JPolicy.w8a8g8(backend="simulated")
        args = (jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, sites),
                jnp.asarray(x, dtype))
        kw = dict(policy=pol, seed=jnp.int32(3), step=jnp.int32(0),
                  x_prev=None if xp is None else jnp.asarray(xp, dtype))
        with jax.disable_jit():
            if which == "time":
                y, stats, (s, last) = jrwkv.rwkv_time_mix(
                    *args, n_heads=H, chunk=CHUNK,
                    state=None if st is None else jnp.asarray(st), **kw)
                carried = (np.asarray(s), _np(last))
            else:
                y, stats, last = jrwkv.rwkv_channel_mix(*args, **kw)
                carried = (_np(last),)
        return _np(y), _np(stats), carried
    tdt = getattr(torch, dtype)
    pol = TPolicy.disabled() if policy == "fp32" else \
        TPolicy.w8a8g8(backend=bk)
    args = (_t(params), _t(sites), torch.from_numpy(x).to(tdt))
    kw = dict(policy=pol, seed=3, step=0,
              x_prev=None if xp is None else torch.from_numpy(xp).to(tdt))
    if which == "time":
        y, stats, (s, last) = trwkv.rwkv_time_mix(
            *args, n_heads=H, chunk=CHUNK,
            state=None if st is None else torch.from_numpy(st), **kw)
        assert s.dtype == torch.float32 and last.dtype == tdt
        carried = (s.numpy(), last.float().numpy())
    else:
        y, stats, last = trwkv.rwkv_channel_mix(*args, **kw)
        carried = (last.float().numpy(),)
    assert y.dtype == tdt
    return (y.float().numpy(),
            jax.tree_util.tree_map(lambda v: v.numpy(), stats), carried)


MIX_CASES = [(w, p, d, m) for w in ("time", "chan")
             for p in ("hindsight", "fp32") for d in ("float32", "bfloat16")
             for m in ("prefill", "decode", "initialized")
             if not (p == "fp32" and m == "initialized")]


@pytest.mark.parametrize("which,policy,dtype,mode", MIX_CASES,
                         ids=["-".join(c) for c in MIX_CASES])
def test_mix_bit_equal_with_xla_primitives(which, policy, dtype, mode,
                                           xla_prims, monkeypatch):
    """Output, carried state (the WKV state, the last row), every site's
    integer image and statistics bit-equal to the reference op by op, on
    both backends; ``initialized`` folds a first run's statistics into
    the sites, so the static single-pass branch runs."""
    params, x, xp, st = _mix_inputs(which, dtype, mode == "decode")
    init = jrwkv.init_rwkv_time_sites if which == "time" else \
        jrwkv.init_rwkv_channel_sites
    sites = _np(init())
    if mode == "initialized":
        sites = _initialized(_call("j", which, params, sites, x, xp, st,
                                   dtype, policy)[1])
    images = {"j": [], "t": []}
    _spy_images(monkeypatch, images)
    y_r, st_r, c_r = _call("j", which, params, sites, x, xp, st, dtype,
                           policy)
    img_r = images["j"]
    n_sites = 5 if which == "time" else 3
    assert len(img_r) == (0 if policy == "fp32" else n_sites)
    fp32_products = policy == "fp32" and dtype == "float32"
    for bk in ("simulated", "fused"):
        images["t"] = []
        y_t, st_t, c_t = _call("t", which, params, sites, x, xp, st, dtype,
                               policy, bk)
        for what, a, b in [("y", y_r, y_t)] + [
                (f"carried {i}", a, b) for i, (a, b) in enumerate(
                    zip(c_r, c_t))]:
            if fp32_products:
                assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max(), what
            else:
                np.testing.assert_array_equal(b, a, f"{bk} {what}")
        assert len(images["t"]) == len(img_r)
        for i, (a, b) in enumerate(zip(img_r, images["t"])):
            np.testing.assert_array_equal(a, b, f"{bk} image {i}")
        lr, lt = _leaves(st_r), _leaves(st_t)
        assert [p for p, _ in lr] == [p for p, _ in lt]
        for (path, a), (_, b) in zip(lr, lt):
            np.testing.assert_array_equal(
                a, b, f"{bk}{jax.tree_util.keystr(path)}")


def test_time_mix_with_torch_primitives(monkeypatch):
    """PyTorch's own primitives (as on the card), bf16 compute: the r, k,
    v, g inputs are the bf16 mixes, their images and statistics equal
    wherever the mixes are (at most a bf16 ulp in 0.1% of them); the
    output and the WKV state within 2% of their largest elements (a
    flipped 8-bit level of the o site moves the output by one step)."""
    params, x, _, _ = _mix_inputs("time", "bfloat16", False, seed=1)
    sites = _np(jrwkv.init_rwkv_time_sites())
    y_r, st_r, (s_r, _) = _call("j", "time", params, sites, x, None, None,
                                "bfloat16", "hindsight")
    y_t, st_t, (s_t, _) = _call("t", "time", params, sites, x, None, None,
                                "bfloat16", "hindsight", "fused")
    assert np.abs(y_t - y_r).max() <= 2e-2 * np.abs(y_r).max()
    assert np.abs(s_t - s_r).max() <= 2e-2 * np.abs(s_r).max()
    for name in ("r", "k", "v", "g", "o"):
        np.testing.assert_allclose(st_t[name]["act"], st_r[name]["act"],
                                   rtol=1e-2, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# One backward: the gradient sites' statistics.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["time", "chan"])
def test_mix_backward_grad_site_statistics(which, monkeypatch):
    """One backward of ``sum(y * G)`` under hindsight W8A8G8 (fp32 compute,
    the reference's noise fed to the port): each gradient site's (min,
    max) within 1e-5 of the leaf's largest element, the time mix's ``o``
    (whose cotangent is ``G`` itself) bit for bit; the input's gradient
    within 1e-3 of its largest element (observed 2.8e-4: the backward's
    fp32 sums run in other orders, and a stochastic-rounding level
    flips)."""
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)
    params, x, _, _ = _mix_inputs(which, "float32", False, seed=2)
    init = jrwkv.init_rwkv_time_sites if which == "time" else \
        jrwkv.init_rwkv_channel_sites
    sites = _np(init())
    g = np.random.default_rng(9).standard_normal((B, S, D)).astype(
        np.float32)

    def ref_loss(sites_j, xj):
        kw = dict(policy=JPolicy.w8a8g8(backend="simulated"),
                  seed=jnp.int32(3), step=jnp.int32(0))
        pj = jax.tree_util.tree_map(jnp.asarray, params)
        if which == "time":
            y = jrwkv.rwkv_time_mix(pj, sites_j, xj, n_heads=H, chunk=CHUNK,
                                    **kw)[0]
        else:
            y = jrwkv.rwkv_channel_mix(pj, sites_j, xj, **kw)[0]
        return jnp.sum(y * jnp.asarray(g))
    gs_r, gx_r = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, sites), jnp.asarray(x))
    gs_r, gx_r = _np(gs_r), np.asarray(gx_r)
    for bk in ("simulated", "fused"):
        ts = _t(_np(sites))
        leaves = [ts[n]["grad"].requires_grad_() for n in ts]
        xt = torch.from_numpy(x).requires_grad_()
        kw = dict(policy=TPolicy.w8a8g8(backend=bk), seed=3, step=0)
        if which == "time":
            y = trwkv.rwkv_time_mix(_t(params), ts, xt, n_heads=H,
                                    chunk=CHUNK, **kw)[0]
        else:
            y = trwkv.rwkv_channel_mix(_t(params), ts, xt, **kw)[0]
        grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(g)),
                                    leaves + [xt])
        for name, got in zip(ts, grads):
            ref = gs_r[name]["grad"]
            assert ref[2] == 1.0 and got[2].item() == 1.0, (bk, name)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=f"{bk} {name}")
        if which == "time":
            np.testing.assert_array_equal(grads[list(ts).index("o")].numpy(),
                                          gs_r["o"]["grad"])
        gx = grads[-1].numpy()
        assert np.abs(gx - gx_r).max() <= 1e-3 * np.abs(gx_r).max(), bk


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------
def test_inits_match_reference_shapes_dtypes_and_constants():
    gen = torch.Generator().manual_seed(0)
    for ref, got in (
            (jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(0), D, H),
             trwkv.init_rwkv_time_mix(gen, D, H)),
            (jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(0), D, FF),
             trwkv.init_rwkv_channel_mix(gen, D, FF))):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert tuple(got[k].shape) == v.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
            if k in ("mu_x", "mu", "w0", "u", "ln_x_scale", "ln_x_bias",
                     "mu_k", "mu_r"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(v), k)
    assert set(trwkv.init_rwkv_time_sites()) == \
        set(jrwkv.init_rwkv_time_sites())
    assert set(trwkv.init_rwkv_channel_sites()) == \
        set(jrwkv.init_rwkv_channel_sites())
