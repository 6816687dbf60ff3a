"""Port vs reference: the CNN slice (``repro_torch.cnn``, ``data.
ImageStream``, ``core.calibration``) against the JAX package on the CPU.

Both sides take the same numpy parameters (``convert.cnn_state_from_jax``)
and batches; the port's stochastic-rounding noise provider is patched to
return the reference's noise.  The reference runs under ``jax.jit``
compiled as written (``test_torch_conv.jit_as_written``: no algebraic
simplifier, which turns the quantizer's ``/ 255`` into a reciprocal
multiply, and no backend optimization, which contracts the estimators'
EMA into an FMA).

Tolerances, stated per test:
  * ``tree_sum``, global average pooling, max pooling, every activation
    site's statistics and quant state, BN's batch and running statistics,
    logits and losses of the forward passes: bit-equal, with the
    reference's ``lax.rsqrt`` read as ``1 / sqrt`` (XLA's CPU rsqrt is an
    approximation of its own: 86% of its results are correctly rounded,
    and neither ``torch.rsqrt`` nor ``1 / sqrt`` reproduces its last bit);
    with XLA's rsqrt itself, BN agrees within 2 ulps (rel 2.4e-7);
  * after a backward pass, the gradient sites' quant states and the
    parameters: max |d| <= 1e-5 * max |ref| per tensor.  The backward's
    fp32 products are summed by PyTorch's BLAS in another order than
    XLA's dot, softmax's ``exp`` and rsqrt's derivative are other
    formulas, and each differs in the last bits;
  * calibration: max |d| <= 1e-3 * max |ref| per leaf.  Its 16-bit grids
    take the fp32 conv path (another summation order than XLA's conv),
    and in eval mode BN applies the fresh running statistics (mean 0,
    var 1), so nothing renormalizes the differences: they grow from
    bit-equal in the first five blocks to 2.5e-4 at block 13;
  * the port's fused and simulated backends: bit-equal to each other.
"""
import dataclasses
import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as jlayers
from repro.cnn import models as jmodels
from repro.cnn import train as jtrain
from repro.core import backend as jbackend
from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JPolicy
from repro.optim import apply_updates as japply
from repro.optim import sgdm as jsgdm
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.cnn import layers as tlayers
from repro_torch.cnn import models as tmodels
from repro_torch.cnn import train as ttrain
from repro_torch.core import backend as tbackend
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.data import ImageStream
from repro_torch.runtime.steps import grads_and_stats, named_params
from repro_torch.telemetry.config import TelemetryConfig
from test_torch_conv import jit_as_written

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["resnet18", "vgg16", "mobilenetv2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU work: these tensors are
    small, and the suite's workers share the cores (with a pool per worker
    ``test_resnet_learns`` ran 50x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)


@pytest.fixture
def ref_rsqrt_as_division(monkeypatch):
    """The reference's CNN layers with ``lax.rsqrt`` read as ``1 / sqrt``
    (see the module docstring); nothing outside ``repro.cnn.layers``
    sees the change."""
    lax = types.SimpleNamespace(**vars(jax.lax))
    lax.rsqrt = lambda v: 1.0 / jnp.sqrt(v)
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    proxy.lax = lax
    monkeypatch.setattr(jlayers, "jax", proxy)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """``{path: numpy array}`` of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy().copy()   # params change
                               if isinstance(v, torch.Tensor)   # in place
                               else np.asarray(v))
    return out


def _params_np(params):
    return {k.replace(".", "/"): v.detach().numpy().copy()
            for k, v in named_params(params).items()}


def _assert_trees(ref, port, what, exact=True, rel=1e-5):
    a, b = _leaves(ref), _leaves(port)
    assert sorted(a) == sorted(b), what
    for k in a:
        if exact:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=rel * np.abs(a[k]).max(),
                                       err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# The order-pinned reductions and BN.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((1, 5), 0), ((7, 3), 0),
                                        ((16, 4), 0), ((33, 2, 3), 0),
                                        ((4, 37, 5), 1)])
def test_tree_sum_and_pooling_match_reference(shape, axis):
    rng = np.random.default_rng(sum(shape))
    v = (rng.standard_normal(shape) * 3).astype(np.float32)
    ref = jit_as_written(lambda a: jlayers.tree_sum(a, axis), jnp.asarray(v))
    np.testing.assert_array_equal(
        tlayers.tree_sum(torch.from_numpy(v), axis).numpy(), np.asarray(ref))
    img = (rng.standard_normal((2, 6, 4, 5)) * 3).astype(np.float32)
    for jf, tf in ((jlayers.avgpool_global, tlayers.avgpool_global),
                   (jlayers.maxpool, tlayers.maxpool)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(img)).numpy(),
            np.asarray(jit_as_written(jf, jnp.asarray(img))))


def _bn_case(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 5, 6)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.random(6).astype(np.float32) + 0.5,
              "bias": rng.standard_normal(6).astype(np.float32)}
    state = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.random(6).astype(np.float32) + 0.5}
    return x, params, state


def _bn_both(train):
    x, params, state = _bn_case()
    yj, sj = jit_as_written(
        lambda a, p, s: jlayers.batchnorm(a, p, s, train=train),
        jnp.asarray(x), params, state)
    yt, st = tlayers.batchnorm(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                              params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()}, train=train)
    return (np.asarray(yj), _np(sj)), (yt.numpy(), _leaves(st))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_reference(train, ref_rsqrt_as_division):
    (yj, sj), (yt, st) = _bn_both(train)
    np.testing.assert_array_equal(yt, yj)
    _assert_trees(sj, st, "bn state")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_with_xla_rsqrt_within_two_ulps(train):
    (yj, sj), (yt, st) = _bn_both(train)
    np.testing.assert_allclose(yt, yj, rtol=2.4e-7, atol=1e-6)
    _assert_trees(sj, st, "bn state")          # the statistics are exact


# ---------------------------------------------------------------------------
# A MobileNetV2 inverted-residual block, two SGD-M steps.
# ---------------------------------------------------------------------------
def _block_apply(L, Q, relu6, params, bn, sites, x, policy, seed, step):
    """tests/test_cnn.py's block, written once for both packages: expand
    -> depthwise -> project with BN and the residual, a pooled head."""
    stats = {}
    h, stats["expand"] = L.qconv(x, params["expand"], sites["expand"],
                                 policy, seed=seed, step=step)
    h, nbn1 = L.batchnorm(h, params["expand_bn"], bn["expand_bn"],
                          train=True)
    h = relu6(h)
    h, stats["dw"] = L.qconv(h, params["dw"], sites["dw"], policy,
                             seed=seed + 1, step=step, groups=h.shape[-1])
    h, nbn2 = L.batchnorm(h, params["dw_bn"], bn["dw_bn"], train=True)
    h = relu6(h)
    h, stats["project"] = L.qconv(h, params["project"], sites["project"],
                                  policy, seed=seed + 2, step=step)
    h, nbn3 = L.batchnorm(h, params["project_bn"], bn["project_bn"],
                          train=True)
    pooled = L.avgpool_global(h + x)
    xq, in_stats, xqi = Q.act_quant_site(pooled, sites["fc"]["act"], policy,
                                         step)
    logits, stats["fc"] = Q.qdense_pre(xq, params["fc"], sites["fc"],
                                       policy, seed=seed + 3, step=step,
                                       qinfo=xqi)
    stats["fc"]["act"] = in_stats
    return logits, {"expand_bn": nbn1, "dw_bn": nbn2, "project_bn": nbn3}, \
        stats


def _block_init():
    cin, mid, classes = 8, 16, 3
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    params = {
        "expand": jlayers.init_conv(ks[0], 1, 1, cin, mid),
        "dw": jlayers.init_conv(ks[1], 3, 3, mid, mid, groups=mid),
        "project": jlayers.init_conv(ks[2], 1, 1, mid, cin),
        "fc": jax.random.normal(ks[3], (cin, classes)) * cin ** -0.5}
    bn = {}
    for k, c in (("expand_bn", mid), ("dw_bn", mid), ("project_bn", cin)):
        params[k], bn[k] = jlayers.init_bn(c)
    sites = {k: jqlinear.init_site() for k in
             ("expand", "dw", "project", "fc")}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 6, cin)))
    return _np(params), _np(bn), _np(sites), x, np.array([0, 2])


def _block_jax(params, bn, sites, x, labels, steps=2):
    policy, opt = JPolicy.w8a8g8(backend="simulated"), jsgdm(momentum=0.9)

    def step_fn(state, step):
        def lf(p, q):
            logits, new_bn, st = _block_apply(
                jlayers, jqlinear, jax.nn.relu6, p, state["bn"], q,
                jnp.asarray(x), policy, jnp.int32(7), step)
            logz = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                                       1)[:, 0]
            return jnp.mean(logz - gold), (new_bn, st)
        (loss, (new_bn, st)), (pg, qg) = jax.value_and_grad(
            lf, argnums=(0, 1), has_aux=True)(state["params"],
                                              state["quant"])
        updates, new_opt = opt.update(pg, state["opt"], state["params"],
                                      0.05)
        return {"params": japply(state["params"], updates), "bn": new_bn,
                "opt": new_opt,
                "quant": jqlinear.update_quant_state(
                    policy, state["quant"],
                    jqlinear.merge_stats(st, qg))}, loss

    state = {"params": params, "bn": bn, "opt": opt.init(params),
             "quant": sites}
    out = []
    for s in range(steps):
        state, loss = jit_as_written(step_fn, state, jnp.int32(s))
        out.append((float(loss), _np(state)))
    return out


def _block_port(backend, params, bn, sites, x, labels, steps=2):
    policy = TPolicy.w8a8g8(backend=backend)
    p, b, q = convert.cnn_state_from_jax(params, bn, sites, device="cpu")
    for t in p.parameters():
        t.requires_grad_(True)
    opt = topt.sgdm(momentum=0.9)
    ost = opt.init(named_params(p))
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    out = []
    for s in range(steps):
        def loss_of_quant(qi):
            logits, new_bn, st = _block_apply(
                tlayers, tqlinear, torch.nn.functional.relu6, p, b, qi, xt,
                policy, 7, s)
            loss = torch.mean(torch.logsumexp(logits, -1)
                              - logits.gather(1, lt[:, None])[:, 0])
            return loss, st, new_bn
        loss, pg, stats, b = grads_and_stats(loss_of_quant, p, q)
        ost = opt.update(pg, ost, named_params(p), 0.05)
        with torch.no_grad():
            q = tqlinear.update_quant_state(policy, q, stats)
        out.append((float(loss), {"params": _params_np(p),
                                  "bn": _leaves(b), "quant": _leaves(q)}))
    return out


def _split(quant):
    """(activation leaves, gradient leaves) of a flattened quant tree."""
    return ({k: v for k, v in quant.items() if k.endswith("act")},
            {k: v for k, v in quant.items() if k.endswith("grad")})


def test_mbv2_block_two_steps_match_reference(jax_noise,
                                              ref_rsqrt_as_division):
    """Two optimizer steps of the block on both port backends against the
    reference's simulated backend."""
    params, bn, sites, x, labels = _block_init()
    ref = _block_jax(params, bn, sites, x, labels)
    port = {bk: _block_port(bk, params, bn, sites, x, labels)
            for bk in ("simulated", "fused")}
    for (ls, ss), (lf, sf) in zip(port["simulated"], port["fused"]):
        assert ls == lf
        for k in ("params", "bn", "quant"):
            _assert_trees(ss[k], sf[k], f"fused vs simulated {k}")
    for s, ((lj, sj), (lt, st)) in enumerate(zip(ref, port["simulated"])):
        assert lt == lj, f"step {s} loss"
        _assert_trees(_leaves(sj["bn"]), st["bn"], f"step {s} bn")
        act_j, grad_j = _split(_leaves(sj["quant"]))
        act_t, grad_t = _split(st["quant"])
        _assert_trees(act_j, act_t, f"step {s} activation quant state")
        _assert_trees(grad_j, grad_t, f"step {s} gradient quant state",
                      exact=False)
        for k, v in grad_t.items():          # the visited flags
            assert v[2] == grad_j[k][2] == 1.0, k
        _assert_trees(_leaves(sj["params"]), st["params"],
                      f"step {s} params", exact=False)


# ---------------------------------------------------------------------------
# The three architectures.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _arch_inputs(arch, classes=7, size=16, batch=2):
    """The reference's bench model (``init`` under one ``jax.jit``: op by
    op it compiles every draw apart), its fresh sites and an input batch,
    as numpy."""
    cfg_j = jmodels.bench_config(arch, num_classes=classes, width=0.25,
                                 image_size=size)
    params, bn = jax.jit(lambda k: jmodels.init(k, cfg_j))(
        jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (batch, size, size, 3)))
    return cfg_j, _np(params), _np(bn), _np(jmodels.init_sites(cfg_j)), x


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_sites_match_reference(arch):
    cfg_j = jmodels.bench_config(arch, num_classes=7, width=0.25,
                                 image_size=16)
    params, bn = jax.eval_shape(lambda: jmodels.init(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = tmodels.bench_config(arch, num_classes=7, width=0.25,
                                 image_size=16)
    p, b = tmodels.init(cfg_t, seed=0, device="cpu")
    q = tmodels.init_sites(cfg_t, TPolicy.w8a8g8(), device="cpu")
    for ref, port in ((params, _params_np(p)), (bn, _leaves(b)),
                      (jmodels.init_sites(cfg_j), _leaves(q))):
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
        assert {k: tuple(v) for k, v in _leaves(shapes).items()} == \
            {k: v.shape for k, v in port.items()}
    # He-normal scale of the convs: std within 15% of sqrt(2 / fan_in)
    w = p["stem"] if arch != "vgg16" else p["c0_0"]
    assert abs(float(w.std()) / (2.0 / 27) ** 0.5 - 1) < 0.15


def test_init_sites_rejects_telemetry_width():
    """A telemetry-enabled policy no longer raises here: every site leaf
    is widened to the width-10 layout (zeros in the new slots), as the
    reference's ``init_sites`` does."""
    pol = dataclasses.replace(TPolicy.w8a8g8(),
                              telemetry=TelemetryConfig(enabled=True))
    q = tmodels.init_sites(tmodels.MOBILENETV2_TINY, pol, device="cpu")
    q3 = tmodels.init_sites(tmodels.MOBILENETV2_TINY, device="cpu")
    ref = _leaves(_np(jmodels.init_sites(jmodels.MOBILENETV2_TINY,
                                         JPolicy.w8a8g8().with_telemetry())))
    got, base = _leaves(q), _leaves(q3)
    assert len(got) == len(ref) == 106
    for k, v in got.items():
        assert v.shape == ref[k].shape == (10,), k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
        np.testing.assert_array_equal(v[:3], base[k], err_msg=k)


# ---------------------------------------------------------------------------
# Calibration, the train step and the driver.
# ---------------------------------------------------------------------------
class _Batches:
    """A stream stand-in that hands both packages the same batches."""

    def __init__(self, batches, as_torch):
        self.batches, self.as_torch = batches, as_torch

    def batch(self, i):
        b = self.batches[i - 10_000]
        if self.as_torch:
            return {k: torch.from_numpy(v) for k, v in b.items()}
        return {k: jnp.asarray(v) for k, v in b.items()}


def test_calibrate_cnn_matches_reference(monkeypatch, ref_rsqrt_as_division):
    """The reference's ``calibrate_cnn``, its forward compiled as written
    (its ``jax.jit`` read as :func:`jit_as_written`)."""
    proxy = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                     if not k.startswith("__")})
    proxy.jit = lambda fn: (lambda *a: jit_as_written(fn, *a))
    monkeypatch.setattr(jtrain, "jax", proxy)
    cfg_j, params, bn, sites, _ = _arch_inputs("mobilenetv2", classes=4)
    rng = np.random.default_rng(3)
    batches = [{"images": rng.standard_normal((2, 16, 16, 3))
                .astype(np.float32) * 2,
                "labels": rng.integers(0, 4, 2)} for _ in range(2)]
    qj = jtrain.calibrate_cnn(cfg_j, params, bn, sites, JPolicy.w8a8g8(),
                              _Batches(batches, False), batches=2)
    cfg_t = tmodels.bench_config("mobilenetv2", num_classes=4, width=0.25,
                                 image_size=16)
    for bk in ("simulated", "fused"):
        p, b, q = convert.cnn_state_from_jax(params, bn, sites, device="cpu")
        qt = ttrain.calibrate_cnn(cfg_t, p, b, q, TPolicy.w8a8g8(backend=bk),
                                  _Batches(batches, True), batches=2)
        act_j, grad_j = _split(_leaves(_np(qj)))
        act_t, grad_t = _split(_leaves(qt))
        _assert_trees(grad_j, grad_t, "gradient leaves (untouched)")
        _assert_trees(act_j, act_t, "activation leaves", exact=False,
                      rel=1e-3)
        assert all(v[2] == 1.0 for v in act_t.values())


def test_image_stream_shapes_and_determinism():
    s = ImageStream(num_classes=5, image_size=8, channels=3, global_batch=6,
                    seed=4)
    a, b = s.batch(3), s.batch(3)
    assert a["images"].shape == (6, 8, 8, 3)
    assert a["images"].dtype == torch.float32
    assert a["labels"].shape == (6,) and a["labels"].dtype == torch.int64
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 5
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], s.batch(4)["images"])
    assert not torch.equal(
        a["images"], ImageStream(5, 8, 3, 6, seed=5).batch(3)["images"])
    half = s.batch(3, shard=1, num_shards=2)
    assert half["images"].shape == (3, 8, 8, 3)
    with pytest.raises(ValueError):
        s.batch(0, num_shards=4)
    # the recipe: 0.6 * the class's fixed pattern + unit noise, so two
    # images of one class correlate and the noise has unit variance
    big = ImageStream(2, 16, 3, 64, seed=0).batch(0)
    imgs, labs = big["images"].reshape(64, -1), big["labels"]
    same = imgs[labs == labs[0]]
    corr = torch.corrcoef(same[:2])[0, 1]
    assert 0.15 < float(corr) < 0.45       # 0.36 / 1.36 in expectation
    assert abs(float(imgs.var()) - 1.36) < 0.1


def test_resnet_learns():
    cfg = tmodels.bench_config("resnet18", num_classes=4, width=0.25,
                               image_size=16)
    run = ttrain.train_cnn(cfg, TPolicy.w8a8g8(backend="fused"), steps=15,
                           batch=16, lr=0.05, device="cpu")
    hist = run.history
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert run.acc > 0.3          # 4 classes, chance = 0.25
    assert all(h["inited_sites"] == hist[0]["inited_sites"] for h in hist)


def test_cnn_train_module_runs_on_cpu(tmp_path):
    trace_path = tmp_path / "cnn_trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cnn.train", "--device", "cpu",
         "--steps", "2", "--batch", "4", "--image-size", "16",
         "--num-classes", "4", "--arch", "mobilenetv2", "--backend",
         "fused", "--trace", str(trace_path)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},     # see one_torch_thread
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final_eval_acc=" in proc.stdout
    assert "step    1" in proc.stdout
    assert trace_path.exists()


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1", "--batch", "2", "--image-size", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.init(tmodels.MOBILENETV2_TINY)
