"""Port vs reference: the MoE LM family (``repro_torch.models.moe`` and the
``"moe"`` block) at reduced size on the CPU.

The reference is the JAX ``simulated`` backend.  Parameters are the
reference's ``init_moe`` / ``init_params`` carried across with
``repro_torch.convert``; inputs are made with numpy from a seed.

Tolerances, stated per test:
  * ``apply_moe`` alone, the reference op by op (under ``jax.jit`` XLA
    fuses ``silu(gate) * up`` and rounds it differently), on both sides
    with the same input:
    the router logits within rtol 1e-5 (fp32 products summed in another
    order); the top-k selection and ``dispatch`` identical; ``combine``
    within rtol 1e-6 (the softmax's ``exp``), and bit-equal when both
    bookkeepers are fed the same gates; the expert input's integer image
    and the (min, max, visited) statistics of every site bit-equal;
    ``aux_loss`` / ``z_loss`` within rtol 1e-5; ``y`` within 1e-5 in fp32
    compute, and within a relative L2 error of 2e-2 and 0.1 absolute in
    bf16 (XLA's bf16 ``logistic`` rounds each of its steps to bf16, so
    ``silu`` of a bf16 gate differs by one bf16 ulp in ~15% of the
    elements, which moves the down projection's 8-bit levels);
  * the whole model: see ``MODEL_TOL``; routing is held identical wherever
    the top-k margin exceeds twice the bound on the router probabilities'
    differences, and any near-tie below it is reported;
  * the train step: the dense step's bounds (``tests/test_torch_train.py``
    ``_check_step``).
The port's two backends agree bit for bit on the CPU throughout.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro import data as jdata
from repro import telemetry as jtelemetry
from repro.core import backend as jbackend
from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.runtime import steps as jsteps
from repro_torch import checkpoint, configs, convert, telemetry
from repro_torch import optim as topt
from repro_torch.core import backend as tbackend
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.launch import serve, train
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.runtime import steps as tsteps

ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]
QWEN = ARCHS[0]


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np(tree))


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _record(monkeypatch, jmod, tmod):
    """Record the gating, the bookkeeping and every activation site's
    integer image of both packages, call by call."""
    rec = {"j": [], "t": []}

    def spy(mod, name, side):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            rec[side].append((name, out))
            return out
        monkeypatch.setattr(mod, name, wrapped)
    for name in ("_top_k_gating", "_dispatch_tensors"):
        spy(jmod, name, "j")
        spy(tmod, name, "t")
    spy(jqlinear, "act_quant_site", "j")
    spy(tqlinear, "act_quant_site", "t")
    return rec


def _by_name(calls, name):
    return [out for n, out in calls if n == name]


# ---------------------------------------------------------------------------
# apply_moe alone.
# ---------------------------------------------------------------------------
B, S = 2, 32


def _layer_inputs(arch, dtype, seed=0):
    cfg_j, cfg_t = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    params_j = jmoe.init_moe(jax.random.PRNGKey(2), cfg_j.d_model, cfg_j.moe)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.dtype(dtype)).astype(jnp.float32))
    return cfg_j, cfg_t, _np(params_j), x


def _run_layer(monkeypatch, cfg_j, cfg_t, params, sites, x, dtype):
    """The reference op by op, and the port on both backends, on the same
    parameters, site states and input.  Returns per side ``(y, stats,
    metrics, record)``."""
    rec = _record(monkeypatch, jmoe, tmoe)
    out = {}
    with jax.disable_jit():      # op by op: jit fuses silu into the product
        y, st, met = jmoe.apply_moe(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, sites),
            jnp.asarray(x, jnp.dtype(dtype)), cfg_j.moe,
            policy=JPolicy.w8a8g8(backend="simulated"), seed=jnp.int32(16),
            step=jnp.int32(0))
    out["ref"] = (_f32(y), _np(st), {k: float(v) for k, v in met.items()},
                  rec["j"])
    for bk in ("simulated", "fused"):
        rec["t"] = []
        y, st, met = tmoe.apply_moe(
            _t(params), _t(sites), torch.from_numpy(x).to(getattr(torch,
                                                                    dtype)),
            cfg_t.moe, policy=TPolicy.w8a8g8(backend=bk), seed=16, step=0)
        out[bk] = (_f32(y), jax.tree_util.tree_map(_f32, st),
                   {k: float(v) for k, v in met.items()}, rec["t"])
    return out


def _initialized(stats):
    """A site tree whose visited leaves hold the observed range (the
    static single-pass branch); unvisited leaves stay fresh."""
    return jax.tree_util.tree_map(
        lambda s: np.asarray([s[0], s[1], 1.0], np.float32) if s[2] > 0.5
        else np.zeros(3, np.float32), stats)


def _check_layer(ref, got, dtype, what):
    y_r, st_r, met_r, rec_r = ref
    y_t, st_t, met_t, rec_t = got
    (lg_r,), (lg_t,) = [_by_name(r, "_top_k_gating")
                        for r in (rec_r, rec_t)]
    (dp_r,), (dp_t,) = [_by_name(r, "_dispatch_tensors")
                        for r in (rec_r, rec_t)]
    gates_r, gates_t = _f32(lg_r[0]), _f32(lg_t[0])     # (gates, aux, z)
    np.testing.assert_array_equal(gates_r > 0, gates_t > 0,
                                  err_msg=f"{what}: top-k selection")
    np.testing.assert_allclose(gates_t, gates_r, rtol=1e-6, atol=1e-7,
                               err_msg=f"{what}: gates")
    np.testing.assert_array_equal(_f32(dp_r[1]), _f32(dp_t[1]),
                                  err_msg=f"{what}: dispatch")
    np.testing.assert_allclose(_f32(dp_t[0]), _f32(dp_r[0]), rtol=1e-6,
                               atol=1e-7, err_msg=f"{what}: combine")
    # every activation site's integer image: the expert input first
    imgs_r = _by_name(rec_r, "act_quant_site")
    imgs_t = _by_name(rec_t, "act_quant_site")
    assert len(imgs_r) == len(imgs_t)
    np.testing.assert_array_equal(np.asarray(imgs_r[0][2].q),
                                  imgs_t[0][2].q.numpy(),
                                  err_msg=f"{what}: expert input image")
    assert imgs_t[0][2].q.shape == imgs_r[0][2].q.shape
    # every site's statistics (up, gate, down, shared/*)
    lr, lt = _leaves(st_r), _leaves(st_t)
    assert [p for p, _ in lr] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lr, lt):
        np.testing.assert_array_equal(
            a, b, err_msg=f"{what}{jax.tree_util.keystr(path)}")
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(met_t[k], met_r[k], rtol=1e-5,
                                   err_msg=f"{what}: {k}")
    if dtype == "float32":
        np.testing.assert_allclose(y_t, y_r, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what}: y")
    else:
        assert np.abs(y_t - y_r).max() <= 0.1, what
        assert np.linalg.norm(y_t - y_r) <= 2e-2 * np.linalg.norm(y_r), what


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0].split('-')[0]}-{p[1]}")
def layer_case(request):
    """Two calls: fresh sites (the first-batch rule), then sites holding
    the first call's observed ranges (the static single-pass branch)."""
    arch, dtype = request.param
    cfg_j, cfg_t, params, x = _layer_inputs(arch, dtype)
    with pytest.MonkeyPatch.context() as mp:
        first = _run_layer(mp, cfg_j, cfg_t, params,
                           _np(jmoe.init_moe_sites(cfg_j.moe)), x, dtype)
    with pytest.MonkeyPatch.context() as mp:
        second = _run_layer(mp, cfg_j, cfg_t, params,
                            _initialized(first["ref"][1]), x, dtype)
    return dtype, cfg_t, {"fresh": first, "initialized": second}


@pytest.mark.parametrize("call", ["fresh", "initialized"])
def test_apply_moe_matches_jax(layer_case, call):
    dtype, _, runs = layer_case
    out = runs[call]
    for bk in ("simulated", "fused"):
        _check_layer(out["ref"], out[bk], dtype, f"{bk} {call}")


def test_apply_moe_router_logits_within_fp32_tolerance(layer_case):
    """The router is fp32 and unquantized: its logits on the layer's input
    within rtol 1e-5 of the reference's (fp32 products summed in another
    order)."""
    dtype, cfg_t, _ = layer_case
    cfg_j, _, params, x = _layer_inputs(cfg_t.name, dtype)
    xg = x.reshape(-1, cfg_j.moe.group_size, cfg_j.d_model)
    lj = np.asarray(jnp.einsum("gtd,de->gte", jnp.asarray(xg),
                               jnp.asarray(params["router"])))
    with tbackend.full_fp32():
        lt = torch.einsum("gtd,de->gte", torch.from_numpy(xg),
                          torch.from_numpy(params["router"])).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    # and both gatings fed the same logits select the same experts
    gj, aj, zj = jmoe._top_k_gating(jnp.asarray(lj), cfg_j.moe)
    gt, at, zt = tmoe._top_k_gating(torch.from_numpy(lj), cfg_t.moe)
    np.testing.assert_array_equal(np.asarray(gj) > 0, gt.numpy() > 0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    np.testing.assert_allclose(float(zt), float(zj), rtol=1e-6)


def test_dispatch_tensors_bit_equal_on_same_gates(layer_case):
    """GShard bookkeeping fed the reference's own gates: combine and
    dispatch bit-equal (the capacity slot built by comparison with
    ``arange(C)``, the reference's ``one_hot(-1)`` an all-zero row)."""
    dtype, cfg_t, runs = layer_case
    (gating,) = _by_name(runs["fresh"]["ref"][3], "_top_k_gating")
    gates = np.asarray(gating[0])
    cap = cfg_t.moe.capacity()
    cj, dj = jmoe._dispatch_tensors(jnp.asarray(gates), None, cap)
    ct, dt = tmoe._dispatch_tensors(torch.from_numpy(gates), cap)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    assert ct.shape[-1] == cap == 16


def test_apply_moe_port_backends_bitwise(layer_case):
    """On the CPU the fused backend runs the kernels' plain versions: the
    same y, statistics, losses and images as the simulated backend."""
    _, _, runs = layer_case
    for out in runs.values():
        ys, ss, ms, rs = out["simulated"]
        yf, sf, mf, rf = out["fused"]
        np.testing.assert_array_equal(ys, yf)
        assert ms == mf
        for (path, a), (_, b) in zip(_leaves(ss), _leaves(sf)):
            np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))
        for a, b in zip(_by_name(rs, "act_quant_site"),
                        _by_name(rf, "act_quant_site")):
            assert torch.equal(a[2].q, b[2].q)


def test_capacity_overflow_drops_the_same_tokens(monkeypatch):
    """A router that sends every token to expert 0 first: per group of 32
    tokens only C = 16 fit, and both packages keep the first 16 (GShard's
    token order) and drop the rest."""
    cfg_j, cfg_t, params, x = _layer_inputs(QWEN, "float32", seed=3)
    params = dict(params)
    router = params["router"].copy()
    router[0, 0] = 50.0
    params["router"] = router
    x = x.copy()
    x[..., 0] = 4.0
    out = _run_layer(monkeypatch, cfg_j, cfg_t, params,
                     _np(jmoe.init_moe_sites(cfg_j.moe)), x, "float32")
    (dp_r,) = _by_name(out["ref"][3], "_dispatch_tensors")
    disp = _f32(dp_r[1])                                   # [G, T, E, C]
    cap = cfg_t.moe.capacity()
    kept0 = disp[:, :, 0].sum(axis=-1)                     # [G, T]
    assert np.all(kept0[:, :cap] == 1) and np.all(kept0[:, cap:] == 0)
    for bk in ("simulated", "fused"):
        _check_layer(out["ref"], out[bk], "float32", f"overflow {bk}")


def test_decode_sized_group(monkeypatch):
    """B = 2 tokens of one step: one group of 2 (smaller than the group
    size 32), capacity clamped up to 4."""
    cfg_j, cfg_t, params, x = _layer_inputs(QWEN, "bfloat16", seed=4)
    x = x[:, :1]
    assert cfg_t.moe.capacity(2) == 4
    out = _run_layer(monkeypatch, cfg_j, cfg_t, params,
                     _np(jmoe.init_moe_sites(cfg_j.moe)), x, "bfloat16")
    (dp_r,) = _by_name(out["ref"][3], "_dispatch_tensors")
    assert _f32(dp_r[1]).shape == (1, 2, cfg_t.moe.n_experts, 4)
    for bk in ("simulated", "fused"):
        _check_layer(out["ref"], out[bk], "bfloat16", f"decode {bk}")


def test_capacity_matches_reference():
    for arch in ARCHS:
        sj, st = jconfigs.get(arch).moe, configs.get(arch).moe
        for g in (1, 2, 4, 7, 32, 100, 512):
            assert st.capacity(g) == sj.capacity(g), (arch, g)
    assert configs.get(QWEN).moe.capacity() == 69
    assert configs.get(QWEN).moe.capacity(4) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for getter in ("get", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, getter)(arch))
        t = dataclasses.asdict(getattr(configs, getter)(arch))
        assert {k: t[k] for k in j} == j


# ---------------------------------------------------------------------------
# The whole model: prefill and decode.
# ---------------------------------------------------------------------------
MS, GEN = 32, 3
# dtype -> (rtol, atol, relative L2) on the logits, and the bound on the
# router probabilities' differences.  fp32: ulps (observed: logits 2e-7
# relative L2, probabilities 3e-7).  bf16: an ulp of a bf16 rounding
# (attention, norms) moves an 8-bit level, and the levels compound
# through the layers and into the router's input (observed: logits 4.2e-2
# relative L2, probabilities 2.2e-2, 3 of 64 tokens of the second layer
# routed differently, all with margins under 3e-3).
MODEL_TOL = {"float32": (1e-4, 1e-4, 1e-4, 1e-5),
             "bfloat16": (5e-2, 0.2, 8e-2, 3e-2)}


def _jax_gating_recorder(monkeypatch, rec, orig):
    def wrapped(logits, spec):
        gates, aux, z = orig(logits, spec)
        jax.debug.callback(lambda lg, g: rec.append((np.asarray(lg),
                                                     np.asarray(g))),
                           logits, gates, ordered=True)
        return gates, aux, z
    monkeypatch.setattr(jmoe, "_top_k_gating", wrapped)


def _torch_gating_recorder(monkeypatch, rec, orig):
    def wrapped(logits, spec):
        gates, aux, z = orig(logits, spec)
        rec.append((logits.numpy().copy(), gates.numpy().copy()))
        return gates, aux, z
    monkeypatch.setattr(tmoe, "_top_k_gating", wrapped)


@pytest.fixture(scope="module", params=["float32", "bfloat16"],
                ids=["f32", "bf16"])
def model_case(request):
    dtype = request.param
    cfg_j = dataclasses.replace(jconfigs.get_reduced(QWEN),
                                compute_dtype=dtype, cache_dtype=dtype)
    cfg_t = dataclasses.replace(configs.get_reduced(QWEN),
                                compute_dtype=dtype, cache_dtype=dtype)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg_j.vocab, (B, MS)).astype(np.int32)
    nxt = rng.integers(0, cfg_j.vocab, (GEN, B, 1)).astype(np.int32)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    policy = JPolicy.w8a8g8(backend="simulated")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        rec = []
        _jax_gating_recorder(mp, rec, jmoe._top_k_gating)
        prefill = jax.jit(lambda p, q, b: jmodel.prefill(
            p, q, b, cfg_j, policy, cache_len=MS + GEN, return_stats=True))
        decode = jax.jit(lambda p, q, t, ps, c: jmodel.decode_step(
            p, q, t, ps, c, cfg_j, policy))
        logits, caches, stats = prefill(params_j, quant_j,
                                        {"tokens": jnp.asarray(tokens)})
        steps = []
        for i in range(GEN):
            lg, caches = decode(params_j, quant_j, jnp.asarray(nxt[i]),
                                jnp.full((B,), MS + i, jnp.int32), caches)
            steps.append(np.asarray(lg))
        jax.effects_barrier()
        out["ref"] = dict(logits=np.asarray(logits), steps=steps,
                          stats=_np(stats), gating=list(rec))
        params_t = convert.params_from_jax(_np(params_j), cfg_t, "cpu")
        gating = tmoe._top_k_gating
        for bk in ("simulated", "fused"):
            rec = []
            _torch_gating_recorder(mp, rec, gating)
            pol = TPolicy.w8a8g8(backend=bk)
            quant_t = convert.from_jax_layout(_np(quant_j), cfg_t, "cpu")
            lt, caches, st = tmodel.prefill(
                params_t, quant_t, {"tokens": torch.from_numpy(tokens).long()},
                cfg_t, pol, cache_len=MS + GEN, return_stats=True)
            steps = []
            for i in range(GEN):
                lg, caches = tmodel.decode_step(
                    params_t, quant_t, torch.from_numpy(nxt[i]).long(),
                    torch.full((B,), MS + i, dtype=torch.long), caches,
                    cfg_t, pol)
                steps.append(lg.numpy())
            out[bk] = dict(logits=lt.numpy(), steps=steps,
                           stats=convert.to_jax_layout(st, cfg_t),
                           gating=list(rec))
    return dtype, out


def _close_logits(a, b, dtype, what):
    rtol, atol, rel, _ = MODEL_TOL[dtype]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)
    assert np.linalg.norm(b - a) <= rel * np.linalg.norm(a), what


def test_moe_prefill_and_decode_logits_match_jax(model_case):
    dtype, out = model_case
    ref = out["ref"]
    for bk in ("simulated", "fused"):
        _close_logits(ref["logits"], out[bk]["logits"], dtype,
                      f"{bk} prefill")
        for i, (a, b) in enumerate(zip(ref["steps"], out[bk]["steps"])):
            _close_logits(a, b, dtype, f"{bk} decode step {i}")


def test_moe_routing_identical_beyond_the_margin(model_case):
    """Per layer call (2 prefill layers, then 2 per decode step): the
    router probabilities within the stated bound ``tol``, and the top-k
    selection of every token identical wherever its k-th and (k+1)-th
    reference probabilities lie more than ``2 tol`` apart (a swap needs
    one of them to move by at least half the margin).  Tokens inside that
    margin are reported, not hidden."""
    dtype, out = model_case
    tol = MODEL_TOL[dtype][3]
    k = configs.get_reduced(QWEN).moe.top_k
    ref = out["ref"]["gating"]
    assert len(ref) == 2 * (1 + GEN)
    for bk in ("simulated", "fused"):
        got = out[bk]["gating"]
        assert len(got) == len(ref)
        near = []
        for call, ((lr, gr), (lt, gt)) in enumerate(zip(ref, got)):
            pr = np.asarray(jax.nn.softmax(jnp.asarray(lr), axis=-1))
            pt = torch.softmax(torch.from_numpy(lt), dim=-1).numpy()
            assert np.abs(pt - pr).max() <= tol, (bk, call)
            srt = -np.sort(-pr, axis=-1)
            margin = srt[..., k - 1] - srt[..., k]
            same = np.all((gr > 0) == (gt > 0), axis=-1)
            decided = margin > 2 * tol
            assert np.all(same[decided]), (bk, call, np.argwhere(
                ~same & decided))
            near += [(call, tuple(ix), float(margin[tuple(ix)]),
                      bool(same[tuple(ix)]))
                     for ix in np.argwhere(~decided)]
        if near:
            flips = [(call, tuple(map(int, ix)), round(m, 5))
                     for call, ix, m, same in near if not same]
            warnings.warn(f"{bk} {dtype}: {len(near)} tokens within the "
                          f"margin {2 * tol}; {len(flips)} routed "
                          f"differently (layer call, token, margin): "
                          f"{flips}")


def test_moe_prefill_stats_tree_matches_jax(model_case):
    """Every site of the prefill (attention, moe/{up,gate,down,shared/*}):
    same tree and visited flags; ranges within the logits' tolerance."""
    dtype, out = model_case
    rtol = MODEL_TOL[dtype][0]
    lr = _leaves(out["ref"]["stats"])
    for bk in ("simulated", "fused"):
        lt = _leaves(out[bk]["stats"])
        assert [p for p, _ in lt] == [p for p, _ in lr]
        for (path, a), (_, b) in zip(lr, lt):
            name = jax.tree_util.keystr(path)
            np.testing.assert_array_equal(a[..., 2], b[..., 2], name)
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-4,
                                       err_msg=f"{bk}{name}")
    names = [jax.tree_util.keystr(p) for p, _ in lr]
    assert any("['moe']['shared']['gate']" in n for n in names)


def test_moe_model_port_backends_bitwise(model_case):
    _, out = model_case
    sim, fus = out["simulated"], out["fused"]
    np.testing.assert_array_equal(sim["logits"], fus["logits"])
    for a, b in zip(sim["steps"], fus["steps"]):
        np.testing.assert_array_equal(a, b)
    for (lg_s, g_s), (lg_f, g_f) in zip(sim["gating"], fus["gating"]):
        np.testing.assert_array_equal(lg_s, lg_f)
        np.testing.assert_array_equal(g_s, g_f)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------
LR, SEQ, TB = 3e-3, 32, 4


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if np.asarray(v).dtype.kind in "iu" else torch.float32)
        for k, v in b.items()}


@pytest.fixture(scope="module")
def train_case():
    """One step of the reference and of the port's two backends from the
    same init state, batch and noise (bf16 compute), and one fp32
    ``loss_fn`` on both sides."""
    cfg_j, cfg_t = jconfigs.get_reduced(QWEN), configs.get_reduced(QWEN)
    policy = JPolicy.w8a8g8(backend="simulated")
    init = _np(jax.jit(lambda k: jsteps.init_train_state(
        k, cfg_j, jadamw(weight_decay=0.0), policy))(jax.random.PRNGKey(0)))
    batch = _np(jdata.for_arch(cfg_j, seq_len=SEQ, global_batch=TB,
                               seed=0).batch(0))
    ts = jax.jit(jsteps.make_train_step(cfg_j, policy,
                                        jadamw(weight_decay=0.0),
                                        jsched.constant(LR)))
    state, met = ts(jax.tree_util.tree_map(jnp.asarray, init), batch)
    s = _np(state)
    ref = (float(met["loss"]), s["quant"], s["params"],
           {k: float(v) for k, v in met.items()})
    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbackend, "site_noise", _jax_noise)
        for bk in ("simulated", "fused"):
            o = topt.adamw(weight_decay=0.0)
            st = convert.train_state_from_jax(init, cfg_t, o, "cpu")
            step = tsteps.make_train_step(cfg_t, TPolicy.w8a8g8(backend=bk),
                                          o, topt.constant(LR))
            st, m = step(st, _torch_batch(batch))
            port[bk] = (float(m["loss"]),
                        convert.to_jax_layout(st["quant"], cfg_t),
                        convert.params_to_jax(st["params"], cfg_t),
                        {k: float(v) for k, v in m.items()})
    # fp32 loss_fn, forward only
    c32j = dataclasses.replace(cfg_j, compute_dtype="float32")
    c32t = dataclasses.replace(cfg_t, compute_dtype="float32")
    lj, (_, mj) = jax.jit(lambda p, q: jmodel.loss_fn(
        p, q, batch, c32j, policy, jnp.int32(0), jnp.int32(0)))(
        jax.tree_util.tree_map(jnp.asarray, init["params"]),
        jax.tree_util.tree_map(jnp.asarray, init["quant"]))
    st = convert.train_state_from_jax(init, c32t, topt.adamw(), "cpu")
    with torch.no_grad():
        lt, (_, mt) = tmodel.loss_fn(st["params"], st["quant"],
                                     _torch_batch(batch), c32t,
                                     TPolicy.w8a8g8(), 0, 0)
    loss_fn = ({"loss": float(lj), **{k: float(v) for k, v in mj.items()}},
               {"loss": float(lt), **{k: float(v) for k, v in mt.items()}})
    return ref, port, loss_fn


def test_moe_loss_fn_matches_jax_fp32(train_case):
    """fp32 compute: loss, nll, aux and z losses within rtol 2e-4.  The
    layer-0 MoE inputs agree to ulps (the attention's ``exp``), which here
    moves one 8-bit level of one token's expert path (observed: that
    token's output 0.046 apart, the layer-1 router logits 0.05, the loss
    6.6e-5 relative; routing identical)."""
    *_, (ref, got) = train_case
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-9,
                                   err_msg=k)
    assert got["aux_loss"] > 0 and got["z_loss"] > 0


def test_moe_train_step_matches_jax_simulated(train_case):
    """The dense step's bounds: loss within 3e-3 relative; the visited
    flags exact, activation ranges within 2e-2 and gradient ranges within
    1e-1 relative; parameters at most 2 lr apart and at most 5% of each
    tensor's elements more than lr/2 apart (AdamW's first step is
    sign-like)."""
    ref, port, _ = train_case
    loss_r, quant_r, params_r, _ = ref
    for bk, (loss_t, quant_t, params_t, _) in port.items():
        assert abs(loss_t - loss_r) <= 3e-3 * abs(loss_r), (bk, loss_t,
                                                             loss_r)
        lq_r, lq_t = _leaves(quant_r), _leaves(quant_t)
        assert [p for p, _ in lq_r] == [p for p, _ in lq_t]
        for (path, a), (_, b) in zip(lq_r, lq_t):
            name = jax.tree_util.keystr(path)
            np.testing.assert_array_equal(a[..., 2], b[..., 2], name)
            tol = 1e-1 if "'grad'" in name else 2e-2
            np.testing.assert_allclose(b, a, rtol=tol, atol=1e-6,
                                       err_msg=f"{bk} {name}")
        lp_r, lp_t = _leaves(params_r), _leaves(params_t)
        assert [p for p, _ in lp_r] == [p for p, _ in lp_t]
        for (path, a), (_, b) in zip(lp_r, lp_t):
            name = jax.tree_util.keystr(path)
            d = np.abs(a - b)
            assert d.max() <= 2 * LR * 1.001, (bk, name, d.max())
            assert float(np.mean(d > LR / 2)) <= 0.05, (bk, name)


def test_moe_aux_losses_present(train_case):
    """As the reference's ``tests/test_train.py::
    test_moe_aux_losses_present``: the step reports a positive aux loss
    and a finite z loss, close to the reference's."""
    ref, port, _ = train_case
    for _, _, _, met in [ref] + list(port.values()):
        assert met["aux_loss"] > 0 and np.isfinite(met["z_loss"])
    for _, _, _, met in port.values():
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(met[k], ref[3][k], rtol=1e-2)


def test_moe_train_backends_bitwise(train_case):
    _, port, _ = train_case
    (ls, qs, ps, _), (lf, qf, pf, _) = port["simulated"], port["fused"]
    assert ls == lf
    for (path, a), (_, b) in zip(_leaves(qs) + _leaves(ps),
                                 _leaves(qf) + _leaves(pf)):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# Round trips: convert, checkpoint, telemetry names.
# ---------------------------------------------------------------------------
def _wide_deep(arch):
    """The reduced widths at the full config's depth and expert count, so
    the stacked expert leaves are ``[24, 60, d, f]`` (qwen2)."""
    full, red = configs.get(arch), configs.get_reduced(arch)
    moe = dataclasses.replace(red.moe, n_experts=full.moe.n_experts,
                              top_k=full.moe.top_k)
    return dataclasses.replace(red, n_layers=full.n_layers, moe=moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_of_stacked_experts(arch):
    cfg_t = _wide_deep(arch)
    cfg_j = dataclasses.replace(jconfigs.get_reduced(arch),
                                n_layers=cfg_t.n_layers,
                                moe=jmoe.MoeSpec(**dataclasses.asdict(
                                    cfg_t.moe)))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    w_up = params["decoder"]["blocks"]["b0"]["moe"]["w_up"]
    assert w_up.shape == (cfg_t.n_layers, cfg_t.moe.n_experts,
                          cfg_t.d_model, cfg_t.moe.d_expert)
    pt = convert.params_from_jax(params, cfg_t, "cpu")
    layer = pt["decoder"]["layers"][5]["moe"]
    np.testing.assert_array_equal(layer["w_up"].numpy(), w_up[5])
    back = convert.params_to_jax(pt, cfg_t)
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back)):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))
    quant = _np(jmodel.init_quant_state(cfg_j, JPolicy.w8a8g8()
                                        .with_telemetry()))
    quant = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), quant)
    qt = convert.from_jax_layout(quant, cfg_t, "cpu")
    assert set(qt["decoder"]["layers"][0]["moe"]) == set(
        tmoe.init_moe_sites(cfg_t.moe))
    qb = convert.to_jax_layout(qt, cfg_t)
    for (path, a), (_, b) in zip(_leaves(quant), _leaves(qb)):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))


def test_moe_train_state_round_trips_the_checkpoint_format(tmp_path):
    """A reference MoE train state saved by ``repro.checkpoint`` loads
    into the port bit-equal; the port's save of it restores in the
    reference bit-equal."""
    cfg_j, cfg_t = jconfigs.get_reduced(QWEN), configs.get_reduced(QWEN)
    state = jax.jit(lambda k: jsteps.init_train_state(
        k, cfg_j, jadamw(), JPolicy.w8a8g8().with_telemetry()))(
        jax.random.PRNGKey(3))
    state["step"] = jnp.int32(2)
    jcheckpoint.save(str(tmp_path / "ref"), 2, state)
    tree = checkpoint.nest(checkpoint.load_arrays(str(tmp_path / "ref"), 2))
    st = convert.train_state_from_jax(tree, cfg_t, topt.adamw(), "cpu")
    assert st["step"] == 2
    for ref_tree, got in ((state["quant"],
                           convert.to_jax_layout(st["quant"], cfg_t)),
                          (state["params"],
                           convert.params_to_jax(st["params"], cfg_t))):
        lr, lt = _leaves(ref_tree), _leaves(got)
        assert [p for p, _ in lr] == [p for p, _ in lt]
        for (path, a), (_, b) in zip(lr, lt):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b,
                                          jax.tree_util.keystr(path))
    # the port's own tree (per-layer entries) through the reference
    checkpoint.save(str(tmp_path / "port"), 2, {
        "params": convert.params_to_jax(st["params"], cfg_t),
        "quant": convert.to_jax_layout(st["quant"], cfg_t)})
    back = jcheckpoint.restore(str(tmp_path / "port"), 2, {
        "params": state["params"], "quant": state["quant"]})
    for (path, a), (_, b) in zip(
            _leaves({"params": state["params"], "quant": state["quant"]}),
            _leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      jax.tree_util.keystr(path))
    # and the port's per-layer state saves and restores itself
    checkpoint.save(str(tmp_path / "self"), 2, st)
    again = checkpoint.restore(str(tmp_path / "self"), 2,
                               tsteps.init_train_state(
                                   cfg_t, topt.adamw(),
                                   TPolicy.w8a8g8().with_telemetry(),
                                   device="cpu"))
    for (path, a), (_, b) in zip(
            _leaves(convert.to_jax_layout(st["quant"], cfg_t)),
            _leaves(convert.to_jax_layout(again["quant"], cfg_t))):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))
    assert torch.equal(again["params"]["decoder"]["layers"][1]["moe"]
                       ["w_down"], st["params"]["decoder"]["layers"][1]
                       ["moe"]["w_down"])


def test_collect_names_moe_sites_as_the_reference():
    """``telemetry.collect(..., cfg=)`` names the port's per-layer MoE
    leaves as the reference's scanned rows, with the same records."""
    cfg_j, cfg_t = jconfigs.get_reduced(QWEN), configs.get_reduced(QWEN)
    pol = JPolicy.w8a8g8().with_telemetry()
    rng = np.random.default_rng(1)
    quant = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) ** 2,
        _np(jmodel.init_quant_state(cfg_j, pol)))
    rj = jtelemetry.collect(jax.tree_util.tree_map(jnp.asarray, quant),
                            skip_unvisited=False)
    rt = telemetry.collect(convert.from_jax_layout(quant, cfg_t, "cpu"),
                           skip_unvisited=False, cfg=cfg_t)
    assert set(rt) == set(rj)
    assert "decoder/blocks/b0/moe/up/act[1]" in rt
    assert "decoder/blocks/b0/moe/shared/gate/grad[0]" in rt
    for name in rj:
        assert rt[name].keys() == rj[name].keys()
        for k in rj[name]:
            np.testing.assert_allclose(rt[name][k], rj[name][k], rtol=1e-6,
                                       err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# The drivers.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_moe_on_cpu(arch):
    run = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert run.tokens.shape == (2, 3)
    assert torch.isfinite(run.prefill_logits).all()
    assert "moe" in run.prefill_stats["decoder"]["layers"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_moe_on_cpu(arch):
    run = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "32"])
    assert len(run.losses) == 2 and np.all(np.isfinite(run.losses))
    for met in run.metrics:
        assert met["aux_loss"] > 0 and np.isfinite(met["z_loss"])
        assert met["loss"] > met["nll"]
