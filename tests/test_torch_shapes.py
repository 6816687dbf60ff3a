"""Port vs reference: the shape matrix (``configs.SHAPES``, ``cells``,
``ArchConfig.supports`` / ``sub_quadratic`` / ``grad_accum_for``,
``input_specs``) and the step factories (``runtime.steps.make_prefill_step``
/ ``make_decode_step``), on the CPU.

The matrix is compared for all ten configs by all four shapes: names,
numbers and skip reasons equal, ``input_specs``' names, shapes and dtypes
equal (the port's are meta tensors, nothing allocated).

The factories run the ``long_500k`` cell's decode at reduced size:
reduced starcoder2-3b (a 16-slot sliding ring), recurrentgemma-9b (RG-LRU
blocks and a 16-slot local ring) and rwkv6-7b (the WKV state).  Both
packages prefill one window through ``make_prefill_step`` on the
reference's parameters (bf16 compute, hindsight W8A8G8), the ring is
re-based to end at position 524286 (every ``pos`` entry shifted by
``524287 - window``, the cached K rotated by the same amount with the
port's ``apply_rope``, the slots rolled so each position sits at its
slot ``pos % L``), and both packages' ``make_decode_step`` decode
from that one numpy cache at positions 524287, 524288 (the ring wraps to
slot 0) and 524289, with the inputs ``input_specs`` gives the cell.

Tolerances: the reference is compiled as written with XLA's bf16 excess
precision off (``test_torch_conv.compile_as_written_bf16``); the bf16
caches (ring k/v/pos, conv tails) bit for bit; the fp32 logits and
recurrent states within 2e-6 of their largest element (the logits
product sums in another order, the RG-LRU carries XLA's
``exp``/``logistic`` ulps, the WKV state its sums' order, within
``tests/test_torch_rwkv.py``'s 1e-6 of its largest).  rwkv's bf16
token-shift rows are the normed outputs of sublayers that read the WKV
state, whose fp32 ulps can flip one bf16 rounding: within one bf16 ulp
of each element, in at most 2% of the elements (observed: 1 of 128, once
in three steps; the next step's logits stay within 2e-6).

At positions near 524287 the reference compiled as written computes the
port's fp32 RoPE angles, and XLA's CPU ``sin``/``cos`` of them differ
from PyTorch's by ulps: ``test_rope_near_524287_is_xla_given_xla_angles``
feeds the port's rotation XLA's ``sin``/``cos`` and gets the reference's
result bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.runtime import steps as jsteps
from repro_torch import configs, convert
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import layers as tlayers
from repro_torch.runtime import steps as tsteps

from test_torch_conv import compile_as_written_bf16
from test_torch_rwkv import _perturb

ARCHS = sorted(jconfigs.names())
SHAPE_NAMES = list(jconfigs.SHAPES)
LONG = "long_500k"
LAST = jconfigs.SHAPES[LONG].seq_len - 1          # position 524287
DECODE_STEPS = 3


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# The matrix.
# ---------------------------------------------------------------------------
def test_configs_cover_the_same_archs():
    assert configs.names() == ARCHS
    assert len(ARCHS) == 10


def test_shapes_equal_reference():
    assert list(configs.SHAPES) == SHAPE_NAMES
    for name, spec in jconfigs.SHAPES.items():
        assert dataclasses.asdict(configs.SHAPES[name]) == \
            dataclasses.asdict(spec)


def test_cells_equal_reference():
    got = [dataclasses.astuple(c) for c in configs.cells()]
    want = [dataclasses.astuple(c) for c in jconfigs.cells()]
    assert got == want
    refused = {c.arch for c in configs.cells() if not c.runnable}
    assert {c.arch for c in configs.cells()} - refused == {
        "starcoder2-3b", "starcoder2-7b", "recurrentgemma-9b", "rwkv6-7b"}
    assert all(c.shape == LONG for c in configs.cells() if not c.runnable)


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_sub_quadratic_and_grad_accum_equal_reference(arch):
    for get in ("get", "get_reduced"):
        cj, ct = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        assert ct.sub_quadratic == cj.sub_quadratic
        for shape in SHAPE_NAMES:
            assert ct.supports(shape) == cj.supports(shape), (get, shape)
            assert ct.grad_accum_for(shape) == cj.grad_accum_for(shape)
    ok, why = configs.get(arch).supports(LONG)
    assert ok == (why == "")


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    want = jconfigs.input_specs(jconfigs.get(arch), jconfigs.SHAPES[shape])
    got = configs.input_specs(configs.get(arch), configs.SHAPES[shape])
    assert list(got) == list(want)
    for name, spec in want.items():
        t = got[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(spec.shape), name
        assert _dtype_name(t.dtype) == str(spec.dtype), name


# ---------------------------------------------------------------------------
# RoPE at the cell's positions.
# ---------------------------------------------------------------------------
def test_rope_near_524287_is_xla_given_xla_angles(monkeypatch):
    """At positions 524270-524300 the port's ``apply_rope`` and the
    reference's compiled as written differ only through XLA's
    ``sin``/``cos``: the fp32 angles ``pos * freq`` are equal, and fed
    XLA's ``sin``/``cos`` the port's rotation is the reference's bit for
    bit; with PyTorch's own it is within 2 ulps of the largest output.
    (Under plain ``jax.jit`` XLA's algebraic simplifier rewrites the
    angle's ``pos * (1 / theta**e)``, and an angle near 5e5 rad moves by
    its fp32 ulp, 2**-5 rad: the rotation then differs by up to ~2e-2.)"""
    hd = 16
    rng = np.random.default_rng(0)
    pos = np.arange(524270, 524301, dtype=np.int32)[None]
    x = rng.standard_normal((1, pos.shape[1], 2, hd)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(pos))
    ref = np.asarray(compile_as_written_bf16(
        lambda a, p: jlayers.apply_rope(a, p, 1e5), *args)(*args))
    own = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e5).numpy()
    np.testing.assert_allclose(own, ref, rtol=0,
                               atol=2 * np.spacing(np.abs(ref).max()))
    for name, fn in (("cos", jnp.cos), ("sin", jnp.sin)):
        orig = getattr(torch, name)

        def xla(t, _f=fn, _o=orig):
            if t.dtype != torch.float32:
                return _o(t)
            return torch.from_numpy(np.array(jax.jit(_f)(jnp.asarray(
                t.numpy()))))
        monkeypatch.setattr(torch, name, xla)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e5).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The step factories at position 524287.
# ---------------------------------------------------------------------------
def _window(cfg) -> int:
    """The ring a cell re-bases: the sliding or local window; rwkv's
    state has no ring, and prefills one chunk's worth of tokens."""
    return cfg.sliding_window or cfg.local_window or 2 * cfg.rwkv_chunk


def _rebase(caches, cfg_t, delta: int):
    """Decode caches (numpy, reference layout) re-based by ``delta``
    positions: every ring ``pos`` entry shifted by ``delta``, the cached K
    rotated by ``delta`` with the port's ``apply_rope`` (RoPE is
    relative), and the slots rolled by ``delta % L`` so that each
    position sits at its slot ``pos % L`` again."""
    def walk(node):
        if isinstance(node, dict):
            if "pos" in node and "k" in node:
                length = node["pos"].shape[-1]
                roll = delta % length
                k = torch.from_numpy(np.asarray(node["k"], np.float32))
                lead = k.shape[:-3]
                k = k.reshape((-1,) + k.shape[-3:])
                shift = torch.full(k.shape[:2], delta, dtype=torch.int32)
                rot = tlayers.apply_rope(k.to(torch.bfloat16), shift,
                                         cfg_t.rope_theta)
                k = np.asarray(jnp.asarray(rot.float().numpy()).astype(
                    node["k"].dtype)).reshape(lead + k.shape[1:])
                pos = np.where(node["pos"] >= 0, node["pos"] + delta,
                               node["pos"]).astype(np.int32)
                return dict(node, k=np.roll(k, roll, axis=-3),
                            v=np.roll(node["v"], roll, axis=-3),
                            pos=np.roll(pos, roll, axis=-1))
            return {key: walk(v) for key, v in node.items()}
        return node
    return walk(caches)


def _native(tree):
    """A JAX tree as numpy arrays of its own dtypes (bf16 kept)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module", params=["starcoder2-3b", "recurrentgemma-9b",
                                        "rwkv6-7b"])
def long_case(request):
    arch = request.param
    cfg_j, cfg_t = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    shape_j, shape_t = jconfigs.SHAPES[LONG], configs.SHAPES[LONG]
    w = _window(cfg_t)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg_j.vocab, (1, w)).astype(np.int32)
    spec = configs.input_specs(cfg_t, shape_t)
    assert tuple(spec["token"].shape) == (1, 1)
    tokens = rng.integers(0, cfg_j.vocab, (DECODE_STEPS,) + tuple(
        spec["token"].shape)).astype(np.int32)
    params_np = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(3), cfg_j))
    if cfg_j.family == "rwkv":
        params_np = _perturb(params_np, 6)
    params_j = jax.tree_util.tree_map(jnp.asarray, params_np)
    quant_j = jmodel.init_quant_state(cfg_j)
    pol_j = JPolicy.w8a8g8(backend="simulated")
    pol_t = TPolicy.w8a8g8(backend="fused")

    # prefill one window through both factories, cache_len = the cell's
    pre_j = jsteps.make_prefill_step(cfg_j, pol_j, cache_len=shape_j.seq_len)
    pargs = (params_j, quant_j, {"tokens": jnp.asarray(prompt)})
    logits_j, caches_j = compile_as_written_bf16(pre_j, *pargs)(*pargs)
    params_t = convert.params_from_jax(params_np, cfg_t, "cpu")
    quant_t = convert.from_jax_layout(jax.tree_util.tree_map(
        np.asarray, quant_j), cfg_t, "cpu")
    pre_t = tsteps.make_prefill_step(cfg_t, pol_t, cache_len=shape_t.seq_len)
    logits_t, caches_t = pre_t(params_t, quant_t,
                               {"tokens": torch.from_numpy(prompt)})
    out = dict(cfg=cfg_t, prefill=(np.asarray(logits_j), logits_t.numpy()),
               prefill_caches=(_native(caches_j),
                               convert.to_jax_layout(caches_t, cfg_t)))

    # one re-based numpy cache for both
    cache = _rebase(_native(caches_j), cfg_t, LAST - w)
    out["rebased"] = cache
    dec_j = jsteps.make_decode_step(cfg_j, pol_j)
    dec_t = tsteps.make_decode_step(cfg_t, pol_t)
    cj = jax.tree_util.tree_map(jnp.asarray, cache)
    ct = convert.from_jax_layout(cache, cfg_t, "cpu")
    compiled = None
    steps = []
    for i in range(DECODE_STEPS):
        pos = np.full(tuple(spec["pos"].shape), LAST + i, np.int32)
        bj = {"token": jnp.asarray(tokens[i]), "pos": jnp.asarray(pos)}
        dargs = (params_j, quant_j, bj, cj)
        compiled = compiled or compile_as_written_bf16(dec_j, *dargs)
        lj, cj = compiled(*dargs)
        bt = {"token": torch.from_numpy(tokens[i]),
              "pos": torch.from_numpy(pos)}
        assert bt["token"].dtype == spec["token"].dtype
        assert bt["pos"].dtype == spec["pos"].dtype
        lt, ct = dec_t(params_t, quant_t, bt, ct)
        steps.append((np.asarray(lj), lt.numpy(), _native(cj),
                      convert.to_jax_layout(ct, cfg_t)))
    out["steps"] = steps
    return out


def _close_fp32(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element of ``a`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return np.exp2(e - 7).astype(np.float32)


def _caches_match(want, got, what):
    lw, lg = _leaves(want), _leaves(got)
    assert [p for p, _ in lw] == [p for p, _ in lg], what
    for (path, a), (_, b) in zip(lw, lg):
        name = what + jax.tree_util.keystr(path)
        a = np.asarray(a, np.float32) if a.dtype.name == "bfloat16" else a
        if name.endswith(("['h']", "['state']")):
            _close_fp32(b, a, name)
        elif name.endswith(("['x_time']", "['x_chan']")):
            d = np.abs(b - a)
            assert np.all(d <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
                          ), name
            assert (d > 0).sum() <= 0.02 * d.size, name
        else:
            np.testing.assert_array_equal(b, a, name)


def test_prefill_step_equals_reference(long_case):
    lj, lt = long_case["prefill"]
    assert np.all(np.isfinite(lt))
    _close_fp32(lt, lj, "prefill logits")
    _caches_match(*long_case["prefill_caches"], "prefill")


def test_rebased_ring_ends_at_524286(long_case):
    """Every ring holds positions 524287 - window .. 524286; rwkv has no
    ring and its state carries no position."""
    cfg, rings = long_case["cfg"], []

    def walk(node):
        if isinstance(node, dict):
            if "pos" in node:
                rings.append(node["pos"])
            for v in node.values():
                walk(v)
    walk(long_case["rebased"])
    if cfg.family == "rwkv":
        assert not rings
        return
    w = _window(cfg)
    assert rings
    for pos in rings:
        assert pos.max() == LAST - 1
        assert sorted(np.unique(pos).tolist()) == list(range(LAST - w, LAST))
        np.testing.assert_array_equal(pos % w, np.broadcast_to(
            np.arange(w), pos.shape))


def test_decode_step_at_524287_equals_reference(long_case):
    """Three decode steps from the re-based cache, past the ring's wrap:
    logits within 2e-6 of their largest, the caches as stated."""
    cfg = long_case["cfg"]
    w = _window(cfg)
    for i, (lj, lt, cj, ct) in enumerate(long_case["steps"]):
        assert np.all(np.isfinite(lt))
        _close_fp32(lt, lj, f"decode step {i} logits")
        _caches_match(cj, ct, f"decode step {i}")
        if cfg.family != "rwkv":
            slot = (LAST + i) % w
            rings = [leaf for path, leaf in _leaves(ct)
                     if jax.tree_util.keystr(path).endswith("['pos']")]
            for pos in rings:
                assert pos[..., slot].max() == LAST + i
    if cfg.family != "rwkv":
        assert (LAST + 1) % w == 0          # the second step wraps the ring
