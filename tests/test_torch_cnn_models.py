"""Port vs reference: the three CNN architectures' forward passes and one
step of the CNN train step, against the JAX package on the CPU.

Same conventions and tolerances as ``tests/test_torch_cnn.py`` (whose
helpers this file uses): forward logits, statistics and BN states
bit-equal with the reference's ``lax.rsqrt`` read as ``1 / sqrt``; after
a backward pass the gradient sites' quant states and the parameters
within 1e-5 of each tensor's largest element, the gradient norm within
rel 1e-5.  These compile the reference's whole models, so they live
apart from the cheaper tests.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import models as jmodels
from repro.cnn import train as jtrain
from repro.core.policy import QuantPolicy as JPolicy
from repro.optim import sgdm as jsgdm
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.cnn import models as tmodels
from repro_torch.cnn import train as ttrain
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.runtime.steps import named_params
from test_torch_cnn import (ARCHS, _arch_inputs, _assert_trees,  # noqa: F401
                            _leaves, _np, _params_np, _split, jax_noise,
                            one_torch_thread, ref_rsqrt_as_division)
from test_torch_conv import jit_as_written


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_rsqrt_as_division):
    """One training-mode forward from fresh sites: logits, statistics and
    the new BN state bit-equal to the reference on both backends."""
    cfg_j, params, bn, sites, x = _arch_inputs(arch)
    lj, bnj, stj = jit_as_written(
        lambda p, b, q, a: jmodels.apply_cfg(cfg_j, p, b, q, a,
                                             JPolicy.w8a8g8(), 0, 0),
        params, bn, sites, jnp.asarray(x))
    cfg_t = tmodels.bench_config(arch, num_classes=7, width=0.25,
                                 image_size=16)
    assert dataclasses.astuple(cfg_t) == dataclasses.astuple(cfg_j)
    for bk in ("simulated", "fused"):
        p, b, q = convert.cnn_state_from_jax(params, bn, sites, device="cpu")
        with torch.no_grad():
            lt, bnt, stt = tmodels.apply_cfg(
                cfg_t, p, b, q, torch.from_numpy(x),
                TPolicy.w8a8g8(backend=bk), 0, 0)
        assert lt.shape == (2, 7)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        _assert_trees(_np(stj), _leaves(stt), f"{bk} stats")
        _assert_trees(_np(bnj), _leaves(bnt), f"{bk} bn")




def test_cnn_train_step_matches_reference(jax_noise, ref_rsqrt_as_division):
    """One step of ``make_cnn_train_step`` (site seeds, clip 5.0, SGD-M
    with weight decay 1e-4, the BN state, one estimator update) against the
    reference's, from the same fresh state (VGG16, the cheapest of the
    three to compile)."""
    cfg_j, params, bn, sites, x = _arch_inputs("vgg16", classes=4,
                                               size=8, batch=4)
    labels = np.array([0, 3, 1, 1])
    jopt = jsgdm(momentum=0.9, weight_decay=1e-4)
    jstep = jtrain.make_cnn_train_step(cfg_j, JPolicy.w8a8g8(), jopt,
                                       lambda s: 0.05)
    sj, mj = jit_as_written(jstep, {"params": params, "bn": bn,
                                    "opt": jopt.init(params), "quant": sites,
                                    "step": jnp.int32(1)},
                            {"images": jnp.asarray(x),
                             "labels": jnp.asarray(labels)})
    cfg_t = tmodels.bench_config("vgg16", num_classes=4, width=0.25,
                                 image_size=8)
    p, b, q = convert.cnn_state_from_jax(params, bn, sites, device="cpu")
    for t in p.parameters():
        t.requires_grad_(True)
    topt_ = topt.sgdm(momentum=0.9, weight_decay=1e-4)
    step_fn = ttrain.make_cnn_train_step(cfg_t, TPolicy.w8a8g8(), topt_,
                                         lambda s: 0.05)
    st, mt = step_fn({"params": p, "bn": b,
                      "opt": topt_.init(named_params(p)), "quant": q,
                      "step": 1},
                     {"images": torch.from_numpy(x),
                      "labels": torch.from_numpy(labels)})
    assert st["step"] == 2
    assert float(mt["loss"]) == float(mj["loss"])
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-5)
    _assert_trees(_np(sj["bn"]), _leaves(st["bn"]), "bn")
    act_j, grad_j = _split(_leaves(_np(sj["quant"])))
    act_t, grad_t = _split(_leaves(st["quant"]))
    _assert_trees(act_j, act_t, "activation quant state")
    _assert_trees(grad_j, grad_t, "gradient quant state", exact=False)
    _assert_trees(_leaves(_np(sj["params"])), _params_np(st["params"]),
                  "params", exact=False)
