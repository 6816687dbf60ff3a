"""Port vs reference: quantization primitives and range estimators.

Same inputs (numpy, seeded) through ``repro.core`` (JAX) and
``repro_torch.core`` (PyTorch, CPU).  Integer images, registers and state
updates are bit-exact: the port repeats the reference's fp32 ops in the
same order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as jest
from repro.core import quant as jquant
from repro_torch.core import estimators as port_est
from repro_torch.core import quant as tquant

SPECS = [(8, False), (8, True), (4, False), (4, True)]


def _pair_spec(bits, sym, stochastic=False):
    return (jquant.QuantSpec(bits=bits, symmetric=sym, stochastic=stochastic),
            tquant.QuantSpec(bits=bits, symmetric=sym, stochastic=stochastic))


def _x(seed, shape=(257,), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


RANGES = [(-1.3, 2.7), (-2.0, 2.0), (0.5, 3.0), (-4.0, -0.25), (0.0, 0.0),
          (1.0, 1.0), (-1e-9, 1e-9), (-127.0, 128.0)]


@pytest.mark.parametrize("bits,sym", SPECS)
@pytest.mark.parametrize("lo,hi", RANGES)
def test_scale_zero_point_bit_exact(bits, sym, lo, hi):
    js, ts = _pair_spec(bits, sym)
    s_j, z_j = jquant.scale_zero_point(jnp.float32(lo), jnp.float32(hi), js)
    s_t, z_t = tquant.scale_zero_point(torch.tensor(lo), torch.tensor(hi), ts)
    _eq(s_j, s_t)
    _eq(z_j, z_t)


@pytest.mark.parametrize("bits,sym", SPECS)
@pytest.mark.parametrize("lo,hi", RANGES)
def test_quantize_dequantize_bit_exact(bits, sym, lo, hi):
    js, ts = _pair_spec(bits, sym)
    x = _x(bits + 3 * sym, scale=max(abs(lo), abs(hi), 1.0))
    qj = jquant.quantize(jnp.asarray(x), lo, hi, js)
    qt = tquant.quantize(torch.from_numpy(x), lo, hi, ts)
    _eq(qj, qt)
    _eq(jquant.dequantize(qj, lo, hi, js), tquant.dequantize(qt, lo, hi, ts))
    _eq(jquant.fake_quant_raw(jnp.asarray(x), lo, hi, js),
        tquant.fake_quant_raw(torch.from_numpy(x), lo, hi, ts))


@pytest.mark.parametrize("sym", [False, True])
def test_half_ties_round_to_even(sym):
    """Inputs placed exactly on .5 grid points: both round half to even."""
    js, ts = _pair_spec(8, sym)
    lo, hi = (-2.0, 2.0) if sym else (0.0, 255.0)
    s, z = tquant.scale_zero_point(torch.tensor(lo), torch.tensor(hi), ts)
    k = torch.arange(-20, 20, dtype=torch.float32) + 0.5
    x = ((k - z) * s).numpy() if sym else (k + 100.0).numpy()
    qj = jquant.quantize(jnp.asarray(x), lo, hi, js)
    qt = tquant.quantize(torch.from_numpy(x), lo, hi, ts)
    _eq(qj, qt)
    if not sym:   # scale 1, zp 0: v = k + 100.5 exactly -> even neighbour
        assert (qt % 2 == 0).all()


def test_stochastic_quantize_same_noise_bit_exact():
    js, ts = _pair_spec(8, False, stochastic=True)
    x = _x(5)
    u = np.random.default_rng(6).random(x.shape, dtype=np.float32)
    _eq(jquant.quantize(jnp.asarray(x), -3.0, 4.0, js, jnp.asarray(u)),
        tquant.quantize(torch.from_numpy(x), -3.0, 4.0, ts,
                        torch.from_numpy(u)))


# ---------------------------------------------------------------------------
# Estimators.
# ---------------------------------------------------------------------------
KINDS = ["hindsight", "running", "current", "fixed", "dsgc"]


def _leaf(inited, seed=11):
    v = np.random.default_rng(seed).standard_normal(2).astype(np.float32)
    return np.array([min(v), max(v), 1.0 if inited else 0.0], np.float32)


# dsgc only on its cached branch: the golden-section search itself is
# not held to bit parity.
EST_CASES = [(k, i) for k in KINDS for i in (False, True)
             if not (k == "dsgc" and not i)]


@pytest.mark.parametrize("kind,inited", EST_CASES)
@pytest.mark.parametrize("observed", [False, True])
def test_estimator_ranges_stats_update_bit_exact(kind, inited, observed):
    """ranges / stats / update for every estimator kind."""
    jcfg = jest.EstimatorConfig(kind=kind, momentum=0.9)
    tcfg = port_est.EstimatorConfig(kind=kind, momentum=0.9)
    js, ts = _pair_spec(8, False)
    x = _x(21, (64, 9))
    leaf = _leaf(inited)
    obs = None
    if observed:
        obs = (np.float32(x.min()), np.float32(x.max()))
    step = 3   # not a dsgc search step
    rj = jest.ranges(jcfg, jnp.asarray(leaf), jnp.asarray(x), js, step=step,
                     observed=None if obs is None
                     else tuple(jnp.asarray(o) for o in obs))
    rt = port_est.ranges(tcfg, torch.from_numpy(leaf), torch.from_numpy(x), ts,
                      step=step, observed=None if obs is None
                      else tuple(torch.tensor(o) for o in obs))
    _eq(rj[0], rt[0])
    _eq(rj[1], rt[1])
    sj = jest.stats(jcfg, jnp.asarray(x), *rj)
    st = port_est.stats(tcfg, torch.from_numpy(x), *rt)
    _eq(sj, st)
    for stat_j, stat_t in ((sj, st), (jnp.zeros(3), torch.zeros(3))):
        _eq(jest.update(jcfg, jnp.asarray(leaf), stat_j),
            port_est.update(tcfg, torch.from_numpy(leaf), stat_t))


def test_estimator_update_stacked_leaves():
    """Elementwise on the last axis: a [L, 3] state updates in one call."""
    jcfg = jest.EstimatorConfig(kind="hindsight", momentum=0.9)
    tcfg = port_est.EstimatorConfig(kind="hindsight", momentum=0.9)
    rng = np.random.default_rng(3)
    leaf = rng.standard_normal((5, 3)).astype(np.float32)
    leaf[:, 2] = [0, 1, 0, 1, 1]
    stat = rng.standard_normal((5, 3)).astype(np.float32)
    stat[:, 2] = [1, 1, 0, 0, 1]
    _eq(jest.update(jcfg, jnp.asarray(leaf), jnp.asarray(stat)),
        port_est.update(tcfg, torch.from_numpy(leaf), torch.from_numpy(stat)))


def test_static_ranges_and_policy_validation():
    from repro_torch.core.policy import QuantPolicy
    cfg = port_est.EstimatorConfig(kind="hindsight")
    lo, hi = port_est.static_ranges(cfg, torch.tensor([0.0, 1.0, 1.0]))
    assert (float(lo), float(hi)) == (0.0, 1.0)
    with pytest.raises(ValueError, match="fully-static"):
        QuantPolicy.w8a8g8(act_kind="current", backend="fused")
    with pytest.raises(ValueError, match="unknown backend"):
        QuantPolicy(backend="tpu")
