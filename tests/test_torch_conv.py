"""Port vs reference: the conv site (``repro_torch.kernels.ops``'s conv
plumbing and ``core.backend.qconv``) against the JAX package on the CPU.

The reference is ``repro.kernels.ops`` (its Pallas int8 matmul in
interpret mode under ``int8_conv_fp``), the int32 ``lax.conv`` oracle
``ref.ref_int8_conv_fp`` and the JAX ``simulated`` backend's conv site.
Both sides take the same numpy inputs; the port's stochastic-rounding
noise provider is patched to return the reference's noise.

Tolerances, stated per test:
  * plans, patch matrices and every lowering, integer images, int32
    contractions (``int8_conv_fp``'s ``alpha * acc``), min/max
    statistics, the conv site's output and its gradient-site statistics:
    bit-equal;
  * the conv site's ``dx``/``dw`` (fp32 products, summed by PyTorch's
    BLAS in another order than XLA's dot): max |d| <= 1e-6 * max |ref|;
  * the fp32 conv path (calibration's 16-bit grids): rel 1e-5.

The reference runs under ``jax.jit`` compiled as written
(:func:`jit_as_written`): without XLA's algebraic simplifier, which
rewrites the quantizer's ``(qmax - qmin) / 255`` into a multiply by the
reciprocal, and without the backend's optimizations, which contract a
multiply and an add (the estimators' EMA) into an FMA.  Either lands an
ulp away from the ops the reference writes, which the port (like JAX op
by op, only slower) computes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as jlayers
from repro.core import backend as jbackend
from repro.core import qlinear as jqlinear
from repro.core.calibration import observation_policy as jobservation
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.cnn import layers as tlayers
from repro_torch.core import backend as tbackend
from repro_torch.core.calibration import observation_policy as tobservation
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import ops as tops

# tests/test_cnn.py's geometries of the conv site
CONV_GEOMS = {
    "strided-same": dict(shape=(2, 9, 9, 8), kh=3, cout=12, stride=2,
                         padding="SAME", groups=1, dil=1),
    "valid": dict(shape=(2, 8, 8, 8), kh=3, cout=12, stride=1,
                  padding="VALID", groups=1, dil=1),
    "grouped": dict(shape=(2, 8, 8, 8), kh=3, cout=16, stride=1,
                    padding="SAME", groups=4, dil=1),
    "depthwise-strided": dict(shape=(2, 8, 8, 8), kh=3, cout=8, stride=2,
                              padding="SAME", groups=8, dil=1),
    "dilated": dict(shape=(1, 10, 10, 4), kh=3, cout=8, stride=1,
                    padding="SAME", groups=1, dil=2),
}
GEOM_IDS = sorted(CONV_GEOMS)


def _w_shape(c):
    return (c["kh"], c["kh"], c["shape"][-1] // c["groups"], c["cout"])


def _plans(c):
    args = (c["shape"], _w_shape(c), c["stride"], c["padding"], c["dil"],
            c["groups"])
    return jops.plan_conv(*args), tops.plan_conv(*args)


def jit_as_written(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without XLA's algebraic simplifier
    and at backend optimization level 0 (see the module docstring); also
    used by ``test_torch_cnn.py``."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_disable_hlo_passes": "algsimp",
        "xla_backend_optimization_level": 0})(*args)


def compile_as_written_bf16(fn, *args):
    """``fn`` compiled for ``args``' shapes as ``jit_as_written`` compiles
    it, with XLA's bf16 excess precision off as well: every bf16 op's
    result is rounded to bf16, as the written ops (and the port) compute
    them, not kept in fp32 across a fusion."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_disable_hlo_passes": "algsimp",
        "xla_backend_optimization_level": 0,
        "xla_allow_excess_precision": False})


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                  err_msg=what)


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)


# ---------------------------------------------------------------------------
# The plan: XLA's padding rules without JAX.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("padding", ["SAME", "VALID", ((2, 0), (1, 3))])
@pytest.mark.parametrize("stride", [1, 2, 3, (2, 1)])
@pytest.mark.parametrize("hw,k,dil", [((7, 8), 3, 1), ((8, 7), 3, 2),
                                      ((9, 9), 1, 1), ((16, 15), 5, 1),
                                      ((6, 10), 2, 1)],
                         ids=["7x8-k3", "8x7-k3-d2", "9x9-k1", "16x15-k5",
                              "6x10-k2"])
def test_plan_conv_matches_reference(hw, k, dil, stride, padding):
    x_shape, w_shape = (2,) + hw + (6,), (k, k, 3, 12)
    pj = jops.plan_conv(x_shape, w_shape, stride, padding, dil, 2)
    pt = tops.plan_conv(x_shape, w_shape, stride, padding, dil, 2)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert (pt.m, pt.k, pt.cin_g, pt.cout_g) == (pj.m, pj.k, pj.cin_g,
                                                 pj.cout_g)


def test_plan_conv_rejects_bad_geometry_and_padding():
    with pytest.raises(ValueError, match="geometry"):
        tops.plan_conv((2, 8, 8, 7), (3, 3, 4, 8), 1, "SAME", 1, 2)
    with pytest.raises(ValueError, match="padding"):
        tops.plan_conv((2, 8, 8, 8), (3, 3, 8, 8), 1, "FULL", 1, 1)
    with pytest.raises(ValueError, match="empty"):
        tops.plan_conv((1, 2, 2, 4), (5, 5, 4, 8), 1, "VALID", 1, 1)


# ---------------------------------------------------------------------------
# im2col / col2im and the layout changes, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("geom", GEOM_IDS)
def test_lowering_matches_reference(geom, dtype):
    c = CONV_GEOMS[geom]
    pj, pt = _plans(c)
    rng = np.random.default_rng(len(geom))
    if dtype == "uint8":
        x = rng.integers(0, 256, c["shape"]).astype(np.uint8)
        pad = 117
    else:
        x = rng.standard_normal(c["shape"]).astype(np.float32)
        pad = 0.0

    def ref(fn, a, *rest):   # the layout ops are exact: jit changes nothing
        return jax.jit(fn, static_argnums=tuple(range(1, 1 + len(rest))))(
            jnp.asarray(a), *rest)

    patches = ref(jops.conv_patches, x, pj, pad)
    _eq(patches, tops.conv_patches(torch.from_numpy(x), pt, pad), "patches")
    if dtype == "uint8":   # the int8 path's form: a 0-dim tensor pad value
        _eq(patches, tops.conv_patches(torch.from_numpy(x), pt,
                                       torch.tensor(117.0)),
            "patches, tensor pad")
    w = rng.standard_normal(_w_shape(c)).astype(np.float32)
    wl = np.asarray(ref(jops.conv_lower_weights, w, pj))
    _eq(wl, tops.conv_lower_weights(torch.from_numpy(w), pt), "lower w")
    _eq(w, tops.conv_unlower_weights(torch.from_numpy(wl.copy()), pt),
        "unlower w")
    y3 = rng.standard_normal((pt.groups, pt.m, pt.cout_g)).astype(np.float32)
    y = np.asarray(ref(jops.conv_unlower_output, y3, pj))
    _eq(y, tops.conv_unlower_output(torch.from_numpy(y3), pt), "unlower y")
    _eq(ref(jops.conv_lower_output, y, pj),
        tops.conv_lower_output(torch.from_numpy(y.copy()), pt), "lower y")
    dp = rng.standard_normal((pt.groups, pt.m, pt.k)).astype(np.float32)
    _eq(ref(jops.conv_unpatch, dp, pj),
        tops.conv_unpatch(torch.from_numpy(dp), pt), "unpatch")


# ---------------------------------------------------------------------------
# The int8 conv: plain path vs the Pallas kernel and the int32 oracle.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("zp", [128.0, 117.3, 0.5, 127.5])
@pytest.mark.parametrize("geom", GEOM_IDS)
def test_int8_conv_fp_plain_matches_reference(geom, zp):
    c = CONV_GEOMS[geom]
    pj, pt = _plans(c)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, c["shape"]).astype(np.uint8)
    w = rng.integers(-127, 128, _w_shape(c)).astype(np.int8)
    alpha = np.float32(3e-4)
    outs_j = [
        jops.int8_conv_fp(jnp.asarray(x), jnp.asarray(w), jnp.float32(zp),
                          alpha, plan=pj),
        jref.ref_int8_conv_fp(jnp.asarray(x), jnp.asarray(w),
                              jnp.float32(zp), alpha,
                              stride=(c["stride"],) * 2,
                              padding=c["padding"],
                              dilation=(c["dil"],) * 2, groups=c["groups"])]
    yt, mnt, mxt = tops.int8_conv_fp(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(zp),
        torch.tensor(alpha), plan=pt)
    assert yt.dtype == torch.float32
    for yj, mnj, mxj in outs_j:
        _eq(yj, yt, "y")
        _eq(mnj, mnt, "min")
        _eq(mxj, mxt, "max")


# ---------------------------------------------------------------------------
# The conv site, forward and backward, both port backends.
# ---------------------------------------------------------------------------
def _site_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(c["shape"]) * 2.0).astype(np.float32)
    w = (rng.standard_normal(_w_shape(c)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(c["cout"]) * 0.01).astype(np.float32)
    return rng, x, w, bias


def _conv_kw(c):
    return dict(stride=c["stride"], padding=c["padding"], dilation=c["dil"],
                groups=c["groups"])


@pytest.mark.parametrize("geom", GEOM_IDS)
def test_qconv_site_matches_reference(geom, jax_noise):
    """Output, activation and gradient-site statistics bit-equal to the JAX
    simulated backend on both port backends; dx/dw within 1e-6 of the
    largest element; the port's backends bit-equal to each other.  The
    loss ``sum(y * r)`` makes the site's incoming cotangent ``r`` itself,
    exact on both sides."""
    c = CONV_GEOMS[geom]
    rng, x, w, bias = _site_inputs(c)
    _, pt = _plans(c)
    r = rng.standard_normal((pt.n, pt.oh, pt.ow, pt.cout)).astype(np.float32)
    jpol = JPolicy.w8a8g8(backend="simulated")

    def f(xin, win, site):
        y, st = jlayers.qconv(xin, win, site, jpol, seed=jnp.int32(3),
                              step=jnp.int32(0), bias=jnp.asarray(bias),
                              **_conv_kw(c))
        return jnp.sum(y * jnp.asarray(r)), (y, st)

    (_, (yj, stj)), (dxj, dwj, gj) = jit_as_written(
        jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True),
        jnp.asarray(x), jnp.asarray(w), jqlinear.init_site())
    out = {}
    for bk in ("simulated", "fused"):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        site = {"act": torch.zeros(3),
                "grad": torch.zeros(3, requires_grad=True)}
        y, st = tlayers.qconv(xt, wt, site, TPolicy.w8a8g8(backend=bk),
                              seed=3, step=0, bias=torch.from_numpy(bias),
                              **_conv_kw(c))
        dx, dw, gs = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                         [xt, wt, site["grad"]])
        _eq(yj, y, f"{bk}: y")
        _eq(stj["act"], st["act"], f"{bk}: act stats")
        _eq(stj["grad"], st["grad"], f"{bk}: grad slot (not visited)")
        _eq(gj["grad"], gs, f"{bk}: grad-site stats")
        for name, a, b in (("dx", dxj, dx), ("dw", dwj, dw)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=f"{bk}: {name}")
        out[bk] = (y, dx, dw, gs)
    for a, b in zip(out["simulated"], out["fused"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("geom", ["strided-same", "depthwise-strided"])
def test_qconv_fp_path_matches_reference(geom):
    """Calibration's 16-bit grids take the fp32 conv of the on-grid values
    (``int8_matmul_eligible`` is false) on both backends: within rel 1e-5
    of the reference's XLA conv (another summation order)."""
    c = CONV_GEOMS[geom]
    _, x, w, bias = _site_inputs(c, seed=1)
    leaf = np.array([-5.0, 5.0, 1.0], np.float32)
    yj, stj = jlayers.qconv(jnp.asarray(x), jnp.asarray(w),
                            {"act": jnp.asarray(leaf),
                             "grad": jnp.zeros(3)},
                            jobservation(JPolicy.w8a8g8()), seed=jnp.int32(0),
                            step=jnp.int32(0), **_conv_kw(c))
    for bk in ("simulated", "fused"):
        yt, stt = tlayers.qconv(torch.from_numpy(x), torch.from_numpy(w),
                                {"act": torch.from_numpy(leaf),
                                 "grad": torch.zeros(3)},
                                tobservation(TPolicy.w8a8g8(backend=bk)),
                                seed=0, step=0, **_conv_kw(c))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-6)
        _eq(stj["act"], stt["act"], "act stats")


def test_full_fp32_is_scoped():
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    try:
        mm.allow_tf32 = cudnn.allow_tf32 = True
        with tbackend.full_fp32():
            assert not mm.allow_tf32 and not cudnn.allow_tf32
        assert mm.allow_tf32 and cudnn.allow_tf32
        with pytest.raises(KeyError):
            with tbackend.full_fp32():
                raise KeyError
        assert mm.allow_tf32 and cudnn.allow_tf32
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


def test_qconv_frozen_weight_takes_the_dequantized_image():
    """Without a recorded weight gradient the site reads the weight's int8
    image only, and the input's gradient still flows."""
    c = CONV_GEOMS["grouped"]
    _, x, w, _ = _site_inputs(c, seed=2)
    pol = TPolicy.w8a8g8(backend="fused")
    site = {"act": torch.zeros(3), "grad": torch.zeros(3)}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tlayers.qconv(xt, torch.from_numpy(w), site, pol, seed=0,
                         step=0, **_conv_kw(c))
    y_ref, _ = tlayers.qconv(torch.from_numpy(x),
                             torch.from_numpy(w).requires_grad_(True), site,
                             pol, seed=0, step=0, **_conv_kw(c))
    assert torch.equal(y.detach(), y_ref.detach())
    (dx,) = torch.autograd.grad(y.sum(), [xt])
    assert dx.shape == xt.shape and torch.isfinite(dx).all()
