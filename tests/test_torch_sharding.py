"""Port vs reference: the sharding rules, the activation hints, the mesh
helpers and the int8 weight gather (``repro_torch.runtime.sharding``,
``repro_torch.launch.mesh``, ``core.qlinear``'s gathered STE) against
``repro.runtime.sharding`` on the CPU.

The reference stacks the scanned layers (a leading repeats dim, ``None``
in its specs); the port stores one entry per layer, so a per-layer leaf's
spec is the reference's without that entry.  Leaves are matched through
``repro_torch.convert`` (each reference leaf's spec index carried into the
port's layout).  Specs compare exactly.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import model as jmodel
from repro.runtime import sharding as jsh
from repro_torch import configs, convert
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, steps

from test_torch_train import _jax_noise, _leaves, _np, _torch_batch  # noqa: F401

SIZES = {"data": 2, "model": 4}


def _stacked(path) -> bool:
    keys = [str(getattr(p, "key", p)) for p in path]
    return len(keys) > 1 and keys[0] in ("decoder", "encoder") \
        and keys[1] == "blocks"


def _port_layout(ref_tree, ref_specs, cfg):
    """``{port dotted name: reference spec}``: the reference's spec of
    each leaf, carried into the port's per-layer layout."""
    paths = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    specs = jax.tree_util.tree_leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, jsh.P))
    idx_tree, table = {}, []
    for (path, leaf), sp in zip(paths, specs):
        stacked = _stacked(path)
        if stacked:
            assert len(sp) == 0 or sp[0] is None, (path, sp)
            sp = tuple(sp)[1:]
        table.append(tuple(sp))
        i = len(table) - 1
        val = np.full((leaf.shape[0],), i) if stacked else np.array(i)
        node = idx_tree
        keys = [str(getattr(p, "key", p)) for p in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    port = convert.from_jax_layout(idx_tree, cfg, "cpu")
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = table[int(t)]
    walk(port, "")
    return out


@pytest.mark.parametrize("name", configs.names())
def test_param_rules_match_reference_every_arch(name):
    """Every leaf of every reduced arch gets the reference's spec (less
    the stacked dim), at the production sizes and on a (2, 4) mesh."""
    assert sorted(configs.names()) == sorted(jconfigs.names())
    jcfg, cfg = jconfigs.get_reduced(name), configs.get_reduced(name)
    jparams = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    params = model.init_params(cfg, device="cpu")
    for jmesh, tmesh in ((None, None),
                         (types.SimpleNamespace(shape=SIZES), SIZES)):
        want = _port_layout(jparams, jsh.param_pspecs(jparams, jmesh), cfg)
        got = sharding.param_pspecs(params, tmesh)
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], sharding.P)
            assert tuple(got[k]) == want[k], (k, got[k], want[k])
            assert len(got[k]) <= params.get_parameter(k).dim()


def test_full_nemotron_shards_every_big_leaf():
    """nemotron-4-340b at full size on fake (meta-backed) tensors: no
    parameter leaf above 64 MB stays replicated on the production mesh,
    nor its AdamW moments."""
    cfg = configs.get("nemotron-4-340b")
    with FakeTensorMode():
        params = model.init_params(cfg, device="cpu")
        shapes = {k: (tuple(p.shape), p.element_size())
                  for k, p in params.named_parameters()}
        specs = sharding.param_pspecs(params)
        opt_specs = sharding.param_pspecs(
            {"m": {k: p for k, p in params.named_parameters()}})
    assert sum(np.prod(s) for s, _ in shapes.values()) > 3.4e11
    for k, (shape, _) in shapes.items():
        nbytes = np.prod(shape) * 4
        if nbytes > 64 * 2 ** 20:
            assert any(ax is not None for ax in specs[k]), \
                f"{k} ({nbytes / 2 ** 20:.0f} MB) replicated"
            assert opt_specs["m"][k] == specs[k]


def test_choose_head_axis_matches_reference():
    assert sharding.choose_head_axis(16, 6, 16) == "kv"
    assert sharding.choose_head_axis(4, 16, 16) == "g"
    assert sharding.choose_head_axis(4, 9, 16) == "g"    # padded, larger
    assert sharding.choose_head_axis(8, 2, 16) == "kv"
    for kv in (1, 2, 4, 8, 16, 32):
        for g in (1, 3, 6, 9, 12, 16):
            for ms in (2, 4, 16):
                assert sharding.choose_head_axis(kv, g, ms) == \
                    jsh.choose_head_axis(kv, g, ms)


def test_hints_are_identity():
    """Without a mapping every hint returns its input object (the
    reference's ``hint(x, ...) is x``); with one too (data-only: the batch
    dim is local; the model axis is not realized), recording the spec."""
    x = torch.zeros((4, 4))
    assert sharding.hint(x, "batch", None) is x
    assert sharding.replicate_hint(x) is x
    q = torch.zeros((2, 8, 2, 3, 4))
    k = torch.zeros((2, 8, 2, 4))
    assert sharding.hint_heads(q, 2, 3) is q
    assert all(a is b for a, b in zip(
        sharding.attn_hints(q, k, k, allow_seq=True), (q, k, k)))
    rec = []
    with sharding.activation_hints({"batch": "data", "model": "model",
                                    "model_size": 4}, record=rec):
        assert sharding.hint(x, "batch", None) is x
        assert sharding.replicate_hint(x) is x
        assert sharding.attn_hints(q, k, k, allow_seq=True)[0] is q
        assert sharding.attn_hints(q, k, k, allow_seq=False)[0] is q
    assert rec == [("hint", sharding.P("data", None)),
                   ("replicate", sharding.P()),
                   ("attn_seq", sharding.P("data", "model", None, None,
                                           None)),
                   ("heads", sharding.P("data", None, None, "model", None))]


@pytest.mark.parametrize("arch, sites", [
    # prefill builds a cache: no sequence-parallel core; G = 2 and KV = 2
    # do not divide 4, the larger (G on a tie) is padded
    ("starcoder2-3b", {("hint", ("data", None, None)),
                       ("heads", ("data", None, None, "model", None))}),
    ("qwen2-moe-a2.7b", {("hint", ("data", None, None)),
                         ("hint", ("model", "data", None, None))}),
    ("recurrentgemma-9b", {("hint", ("data", None, None)),
                           ("hint", ("data", None, "model"))}),
    ("rwkv6-7b", {("hint", ("data", None, None)),
                  ("hint", ("data", "model", None, None)),
                  ("heads", ("data", "model", None, None))}),
])
def test_model_hint_sites(arch, sites):
    """A reduced model's prefill under a mapping takes the reference's
    hints at its sites (the unit's input, the attention core, the experts'
    input, the RG-LRU's decay, RWKV's mix and heads) and computes what it
    computes without one."""
    cfg = configs.get_reduced(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    quant = model.init_quant_state(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    policy = QuantPolicy.w8a8g8()
    plain, _ = model.prefill(params, quant, {"tokens": tokens}, cfg, policy)
    rec = []
    with sharding.activation_hints({"batch": "data", "seq": None,
                                    "embed": None, "model": "model",
                                    "model_size": 4}, record=rec):
        hinted, _ = model.prefill(params, quant, {"tokens": tokens}, cfg,
                                  policy)
    assert torch.equal(plain, hinted)
    taken = {(site, tuple(spec)) for site, spec in rec}
    assert sites <= taken, taken


def _ref_cache_specs(cfg_name, b, length):
    jcfg = jconfigs.get_reduced(cfg_name)
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, length))
    return cache, jsh.cache_pspecs(cache, types.SimpleNamespace(shape=SIZES),
                                   ("data",))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-9b",
                                  "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_batch_and_cache_specs_match_reference(arch):
    """``cache_pspecs`` on a reduced arch's decode cache (KV, ring
    positions, RG-LRU and WKV state, token-shift rows) and
    ``batch_pspecs`` (a divisible and an indivisible batch) give the
    reference's specs."""
    cfg = configs.get_reduced(arch)
    jcache, jspecs = _ref_cache_specs(arch, 4, 32)
    want = _port_layout(jcache, jspecs, cfg)
    got = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            got[prefix[:-1]] = t
    walk(sharding.cache_pspecs(model.init_cache(cfg, 4, 32, "cpu"), SIZES,
                               ("data",)), "")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == want[k], (k, got[k], want[k])
    jm = types.SimpleNamespace(shape=SIZES)
    for bsz in (4, 3):
        batch = {"tokens": np.zeros((bsz, 8), np.int32),
                 "mask": np.zeros((bsz, 8), np.float32)}
        jb = jsh.batch_pspecs(batch, jm, ("data",))
        tb = sharding.batch_pspecs({k: torch.from_numpy(v)
                                    for k, v in batch.items()}, SIZES,
                                   ("data",))
        assert {k: tuple(v) for k, v in tb.items()} == \
            {k: tuple(v) for k, v in jb.items()}


def test_placements_and_named():
    """A spec as DTensor placements over a mesh's named dims, and a spec
    tree as ``(mesh, placements)`` leaves."""
    from torch.distributed.tensor import Replicate, Shard
    m = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    P = sharding.P
    assert sharding.placements(P(("data", "model"), None), m) == \
        (Shard(0), Shard(0))
    assert sharding.placements(P(None, "model"), m) == (Replicate(),
                                                        Shard(1))
    assert sharding.placements(P(), m) == (Replicate(), Replicate())
    tree = sharding.named({"a": P("data"), "b": [P(None, "model")]}, m)
    assert tree["a"] == (m, (Shard(0), Replicate()))
    assert tree["b"][0] == (m, (Replicate(), Shard(1)))
    state = steps.init_train_state(configs.get_reduced("starcoder2-3b"),
                                   __import__("repro_torch").optim.adamw(),
                                   seed=0, device="cpu")
    specs = sharding.train_state_pspecs(state, SIZES)
    assert specs["step"] == P() and specs["opt"]["count"] == P()
    assert specs["opt"]["m"] == specs["params"]
    assert all(s == P() for s in __import__(
        "repro_torch.core.state", fromlist=["x"]).tree_leaves(
            specs["quant"]))


def test_mesh_helpers():
    """The production mesh is built by a function (importing the module
    touches no process group); its DP axes and chip counts are the
    reference's."""
    import repro.launch.mesh as jmesh
    assert mesh.dp_axes() == jmesh.dp_axes() == ("data",)
    assert mesh.dp_axes(True) == jmesh.dp_axes(True)
    assert mesh.num_chips() == 256 and mesh.num_chips(True) == 512
    assert not torch.distributed.is_initialized()
    assert not hasattr(mesh, "PEAK_FLOPS_BF16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_ste_matches_reference(dtype):
    """The gathered STE on a weight: the on-grid values and the clipped-STE
    gradient (a range narrower than the weight's, so some elements clip)
    bit for bit against the reference's ``_fake_quant_ste_gathered``."""
    from repro.core import qlinear as jql
    from repro.core import quant as jquant
    from repro_torch.core import qlinear as tql
    from repro_torch.core import quant as tquant
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    g = rng.standard_normal((64, 48)).astype(np.float32)
    mn, mx = np.float32(-0.08), np.float32(0.07)
    jspec = jquant.QuantSpec(bits=8, symmetric=True)
    tspec = tquant.QuantSpec(bits=8, symmetric=True)
    jw = jnp.asarray(w).astype(dtype)
    yj, vjp = jax.vjp(lambda x: jql._fake_quant_ste_gathered(x, mn, mx,
                                                              jspec), jw)
    (gj,) = vjp(jnp.asarray(g).astype(dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_(True)
    yt = tql._GatheredSTE.apply(tw, torch.tensor(mn), torch.tensor(mx),
                                tspec)
    (gt,) = torch.autograd.grad(yt, tw, torch.from_numpy(g).to(tw.dtype))
    np.testing.assert_array_equal(np.asarray(yj.astype(jnp.float32)),
                                  yt.detach().float().numpy())
    np.testing.assert_array_equal(np.asarray(gj.astype(jnp.float32)),
                                  gt.float().numpy())
    assert 0 < float((gt == 0).float().mean()) < 0.5


def test_int8_weight_gather_matches_reference(jax_noise_fixture):
    """``QuantPolicy(int8_weight_gather=True)``: the weight's int8 image
    pinned replicated inside the STE, dequantized after; the flag takes
    the int8 matmul off (fp32 contractions of the on-grid values, in
    XLA's and PyTorch's summation orders).  One forward + backward of the
    reduced model in fp32 against the reference with the flag on, its
    noise patched in: the loss within 1e-3 relative (an ulp in an fp32
    product flips a static 8-bit activation level; observed 2.2e-4), every
    gradient within 5e-2 relative L2, the bound ``test_torch_train``'s fp32
    gradient test holds its layers to: the head's fp32 logits already move
    its cotangent's stochastic rounding by a level here and there
    (observed 1.3e-2 on the head, 4.6e-3 on the final norm's bias), where
    with the int8 contractions they agree to 1e-6."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("starcoder2-3b"),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced("starcoder2-3b"),
                              compute_dtype="float32")
    jpol = dataclasses.replace(JPolicy.w8a8g8(backend="simulated"),
                               int8_weight_gather=True)
    pol = dataclasses.replace(QuantPolicy.w8a8g8(), int8_weight_gather=True)
    from repro import data as jdata
    from repro.optim import adamw as jadamw
    from repro.runtime import steps as jsteps
    from repro_torch import optim as topt
    init = _np(jsteps.init_train_state(jax.random.PRNGKey(0), jcfg,
                                       jadamw(), jpol))
    batch = _np(jdata.for_arch(jcfg, seq_len=32, global_batch=4,
                               seed=0).batch(0))
    st = jax.tree_util.tree_map(jnp.asarray, init)
    (loss_j, _), (pg_j, _) = jax.jit(jax.value_and_grad(
        lambda p, q: jmodel.loss_fn(p, q, batch, jcfg, jpol, jnp.int32(0),
                                    jnp.int32(0)),
        argnums=(0, 1), has_aux=True))(st["params"], st["quant"])
    tst = convert.train_state_from_jax(init, cfg, topt.adamw(), "cpu")
    loss_t, grads, _, _ = steps.forward_backward(
        cfg, pol, tst["params"], tst["quant"], _torch_batch(batch), 0, 0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
    got = convert.params_to_jax(tst["params"], cfg, grads)
    for (path, a), (_, b) in zip(_leaves(_np(pg_j)), _leaves(got)):
        name = jax.tree_util.keystr(path)
        err = np.linalg.norm(b - a)
        if "'bk'" in name:
            assert err <= 0.05 * np.linalg.norm(a) + 1e-3, name
            continue
        assert err <= 5e-2 * np.linalg.norm(a), (name,
                                                err / np.linalg.norm(a))


@pytest.fixture
def jax_noise_fixture(monkeypatch):
    from repro_torch.core import backend as tbackend
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)
