"""Port vs reference: ``gelu`` (``models/layers.activation``) as
``jax.nn.gelu`` computes it, and what it feeds: starcoder2's bf16 MLP and
prefill, on the CPU.

Tolerances, stated per test:
  * ``gelu``: bit-equal in bf16, forward and vjp; in fp32 the port
    differs from ``jax.nn.gelu`` only through XLA's ``tanh``
    approximation, which the test shows by feeding the port's form XLA's
    ``tanh`` (bit-equal), and bounds at 4 ulps of max(|x|, |gelu(x)|)
    (observed 2: the ``tanh`` error, ulps of 1, scaled by x / 2);
  * the MLP layer in bf16 compute against the reference run op by op
    (``jax.disable_jit``), and the prefill against the reference compiled
    as written with XLA's bf16 excess precision off
    (``test_torch_conv.compile_as_written_bf16``): integer images, every
    site's statistics and the MLP's output bit for bit, the prefill's fp32
    logits product within 2e-6 (its sums run in another order).  Under
    plain ``jax.jit`` XLA keeps fused bf16 intermediates in fp32
    (``tests/test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

from test_torch_conv import compile_as_written_bf16
from test_torch_dense import B, S, _leaves, _np, _reduced


def _x(shape=(256, 1024), seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(
        np.float32)


def test_gelu_bf16_bit_equal_to_jax():
    x = jnp.asarray(_x()).astype(jnp.bfloat16)
    ref = np.asarray(jax.nn.gelu(x).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tlayers.activation(xt, "gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_gelu_bf16_vjp_bit_equal_to_jax():
    """The backward: JAX's vjp of the form, op by op, in bf16."""
    x = jnp.asarray(_x()).astype(jnp.bfloat16)
    g = jnp.asarray(_x(seed=1)).astype(jnp.bfloat16)
    ref = np.asarray(jax.vjp(jax.nn.gelu, x)[1](g)[0].astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    gt = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(
        torch.bfloat16)
    (got,) = torch.autograd.grad(tlayers.activation(xt, "gelu"), xt, gt)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_gelu_fp32_residual_is_xla_tanh(monkeypatch):
    x = _x()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    real = tlayers.activation(torch.from_numpy(x), "gelu").numpy()
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(x)))
    assert np.all(np.abs(real - ref) <= 4 * ulp)
    assert np.mean(real != ref) > 0.01        # the residual exists ...
    monkeypatch.setattr(torch, "tanh", lambda t: torch.from_numpy(
        np.asarray(jnp.tanh(jnp.asarray(t.numpy())))))
    xla = tlayers.activation(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_array_equal(xla, ref)   # ... and is XLA's tanh


@pytest.mark.parametrize("initialized", [False, True])
def test_bf16_gelu_mlp_site_statistics_match_reference_op_by_op(
        initialized):
    """starcoder2's MLP (gelu, biases) in bf16 on both port backends: the
    down projection's input image, every site's statistics and the output
    equal the reference's op-by-op run, bit for bit."""
    d, f = 64, 256
    params = _np(jlayers.init_mlp(jax.random.PRNGKey(5), d, f, "gelu",
                                  use_bias=True))
    params["b_up"] = np.random.default_rng(6).standard_normal(f).astype(
        np.float32) * 0.1
    sites = _np(jlayers.init_mlp_sites("gelu"))
    if initialized:
        sites = jax.tree_util.tree_map(
            lambda s: np.asarray([-3.0, 4.0, 1.0], np.float32), sites)
    x = np.asarray(jnp.asarray(_x((2, 16, d), 3)).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    images = {"j": [], "t": []}
    with pytest.MonkeyPatch.context() as mp:
        for side, mod in (("j", jqlinear), ("t", tqlinear)):
            orig = mod.act_quant_site

            def spy(*a, _o=orig, _s=side, **k):
                out = _o(*a, **k)
                images[_s].append(np.asarray(out[2].q))
                return out
            mp.setattr(mod, "act_quant_site", spy)
        with jax.disable_jit():
            yj, sj = jlayers.apply_mlp(
                jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, sites),
                jnp.asarray(x, jnp.bfloat16), "gelu",
                JPolicy.w8a8g8(backend="simulated"), jnp.int32(16),
                jnp.int32(0))
        ref_images = images["j"]
        for bk in ("simulated", "fused"):
            images["t"] = []
            yt, st = tlayers.apply_mlp(
                jax.tree_util.tree_map(torch.from_numpy, params),
                jax.tree_util.tree_map(torch.from_numpy, sites),
                torch.from_numpy(x).to(torch.bfloat16), "gelu",
                TPolicy.w8a8g8(backend=bk), 16, 0)
            assert len(images["t"]) == len(ref_images) == 2
            for a, b in zip(ref_images, images["t"]):
                np.testing.assert_array_equal(a, b, f"{bk} image")
            for (path, a), (_, b) in zip(_leaves(_np(sj)), _leaves(
                    jax.tree_util.tree_map(lambda t: t.numpy(), st))):
                np.testing.assert_array_equal(a, b, f"{bk}{path}")
            np.testing.assert_array_equal(
                yt.float().numpy(), np.asarray(yj.astype(jnp.float32)))


def test_bf16_prefill_matches_reference_as_written():
    """starcoder2-7b reduced in bf16 compute, hindsight, S past the window:
    every site's prefill statistics equal the reference's bit for bit when
    the reference computes its written ops (``compile_as_written_bf16``: no
    excess precision), and the last position's
    fp32 logits product agrees within 2e-6 (its sums run in another
    order)."""
    cfg_j, cfg_t = _reduced("starcoder2-7b", "bfloat16")
    tokens = np.random.default_rng(11).integers(0, cfg_j.vocab, (B, S))
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    args = (params_j, quant_j, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lj, _, sj = compile_as_written_bf16(
        lambda p, q, b: jmodel.prefill(p, q, b, cfg_j,
                                       JPolicy.w8a8g8(backend="simulated"),
                                       return_stats=True), *args)(*args)
    lt, _, st = tmodel.prefill(
        convert.params_from_jax(_np(params_j), cfg_t, "cpu"),
        convert.from_jax_layout(_np(quant_j), cfg_t, "cpu"),
        {"tokens": torch.from_numpy(tokens).long()}, cfg_t,
        TPolicy.w8a8g8(backend="fused"), return_stats=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=2e-6)
    for (path, a), (_, b) in zip(_leaves(_np(sj)), _leaves(
            convert.to_jax_layout(st, cfg_t))):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))
