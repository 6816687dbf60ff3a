"""Port vs reference: the enc-dec family (seamless-m4t-medium: ``"enc"``
bidirectional encoder blocks, ``"xattn"`` decoder blocks with cross
attention on the encoder's output) at reduced size on the CPU.

The reference's ``init_params`` / train state are carried across with
``repro_torch.convert``; inputs are made with numpy from a seed.  The
reduced config has 2 encoder and 2 decoder layers, d 64 in 4 heads of
16.  The frames are 132 long, so ``tuning.attention_block`` picks a kv
tile of 128 (encoder, ``(132, 132, 16)``) or 64 (cross core, ``(20, 132,
16)``), and the last kv tile is padded: ``skv`` is not a multiple of
``bkv``, as at the full config's 1056 frames.  The Pallas interpret
mode pads that tail differently from the oracle and the CUDA kernel,
which matters only for a non-integer probability zero point; on this
path zp_p is 0 whatever the p-site's range (probabilities are
non-negative and the range is clamped to include 0), and the tests
assert it.

Tolerances, stated per test:
  * the cross-attention layer under ``w8a8g8`` hindsight, both backends
    against the reference compiled as written: the core's integer images,
    its output and every site's statistics bit for bit;
  * prefill and decode in bf16 compute (the config's), hindsight, against
    the reference compiled as written with XLA's bf16 excess precision
    off (``test_torch_conv.compile_as_written_bf16``): every site's
    prefill statistics (the encoder's included) and the bf16 caches
    (``kv`` and the cross ``xkv``) bit for bit; the fp32 logits within
    2e-6 (the logits product sums in another order);
  * one train step against the reference compiled as written: the loss
    within 1e-6 relative, every quant leaf bit for bit, the parameters
    within 1e-5 of each tensor's largest element.  AdamW's first step is
    ``lr * g / (|g| + eps)``, the sign of the gradient: where a bf16
    gradient element sits at its rounding noise (a bias summed over every
    row, |g| ~ 1e-4 of the tensor's largest; the k biases, whose exact
    gradient is zero) the two packages' backward sums may give it either
    sign, and where |g| nears AdamW's eps the step is a fraction of lr
    that moves with g's last bits.  Those elements, at most 1e-3 of all
    (the k biases aside; observed 55 of 233856), are held within the
    step's span of 2 lr;
  * prefill-then-decode against a re-prefill under
    ``QuantPolicy.disabled()``: the reference's ``rtol 2e-2, atol 2e-3``
    (``tests/test_models.py::test_prefill_decode_consistency``, which
    leaves the enc-dec family out) in bf16 compute, in the reference
    and in the port; 1e-5 in fp32 compute in the port.
The port's two backends agree bit for bit on the CPU throughout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import telemetry as jtelemetry
from repro.core import backend as jbackend
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import int8_attention as jattn_kernel
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.runtime import steps as jsteps
from repro_torch import configs, convert, data, telemetry
from repro_torch import optim as topt
from repro_torch.core import backend as tbackend
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import int8_attention as tattn_kernel
from repro_torch.kernels import tuning
from repro_torch.launch import serve, train
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.runtime import steps as tsteps

from test_torch_conv import compile_as_written_bf16

ARCH = "seamless-m4t-medium"
B, MS, GEN, FRAMES = 2, 20, 4, 132


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.array(a), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if np.asarray(v).dtype.kind in "iu" else torch.float32)
        for k, v in batch.items()}


def assert_trees_equal(ref, got, what=""):
    lr, lt = _leaves(ref), _leaves(got)
    assert [p for p, _ in lr] == [p for p, _ in lt], what
    for (path, a), (_, b) in zip(lr, lt):
        np.testing.assert_array_equal(
            a, b, f"{what}{jax.tree_util.keystr(path)}")


def assert_configs_match(arch):
    for get in ("get", "get_reduced"):
        cj, ct = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), (get, f.name)
        for n in (1, 33, 1056, 32768):
            assert ct.enc_len(n) == cj.enc_len(n)


def count_parameters(arch) -> int:
    cfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))


def convert_round_trip(arch, cache_len: int):
    """Random params, quant state and caches in the reference's layout ->
    the port's -> back, bit for bit.  Returns the port's trees."""
    cfg_j, cfg_t = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    rng = np.random.default_rng(0)

    def rand(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32), tree)
    trees = {
        "params": rand(jax.eval_shape(lambda k: jmodel.init_params(k, cfg_j),
                                      jax.random.PRNGKey(0))),
        "quant": rand(_np(jmodel.init_quant_state(cfg_j))),
        "cache": rand(jax.eval_shape(lambda: jmodel.init_cache(
            cfg_j, 2, cache_len))),
    }
    port = {"params": convert.params_from_jax(trees["params"], cfg_t, "cpu")}
    back = {"params": convert.params_to_jax(port["params"], cfg_t)}
    for key in ("quant", "cache"):
        port[key] = convert.from_jax_layout(trees[key], cfg_t, "cpu")
        back[key] = convert.to_jax_layout(port[key], cfg_t)
    for key, tree in trees.items():
        assert_trees_equal(tree, back[key], key)
    return trees, port


def reference_serve(cfg_j, params_j, quant_j, prompt: dict, cache_len: int,
                    nxt, pos0: int):
    """The reference's prefill + decode steps (tokens ``nxt`` from
    ``pos0``), compiled as written; numpy results."""
    policy = JPolicy.w8a8g8(backend="simulated")

    def pf(p, q, b):
        return jmodel.prefill(p, q, b, cfg_j, policy, cache_len=cache_len,
                              return_stats=True)

    def df(p, q, t, pos, c):
        return jmodel.decode_step(p, q, t, pos, c, cfg_j, policy)

    pargs = (params_j, quant_j, jax.tree_util.tree_map(jnp.asarray, prompt))
    logits, caches, stats = compile_as_written_bf16(pf, *pargs)(*pargs)
    decode, steps = None, []
    for i, tok in enumerate(nxt):
        dargs = (params_j, quant_j, jnp.asarray(tok),
                 jnp.full((tok.shape[0],), pos0 + i, jnp.int32), caches)
        decode = decode or compile_as_written_bf16(df, *dargs)
        lg, caches = decode(*dargs)
        steps.append(np.asarray(lg))
    return dict(logits=np.asarray(logits), steps=steps, stats=_np(stats),
                caches=_np(caches))


def port_serve(cfg_t, params_j, quant_j, prompt: dict, cache_len: int, nxt,
               pos0: int):
    """The port's prefill + decode steps on both backends."""
    params_t = convert.params_from_jax(_np(params_j), cfg_t, "cpu")
    out = {}
    for bk in ("simulated", "fused"):
        pol = TPolicy.w8a8g8(backend=bk)
        quant_t = convert.from_jax_layout(_np(quant_j), cfg_t, "cpu")
        lt, caches, st = tmodel.prefill(
            params_t, quant_t, _torch_batch(prompt), cfg_t, pol,
            cache_len=cache_len, return_stats=True)
        prefill_caches = convert.to_jax_layout(caches, cfg_t)
        steps = []
        for i, tok in enumerate(nxt):
            lg, caches = tmodel.decode_step(
                params_t, quant_t, torch.from_numpy(tok).long(),
                torch.full((tok.shape[0],), pos0 + i, dtype=torch.long),
                caches, cfg_t, pol)
            steps.append(lg.numpy())
        out[bk] = dict(logits=lt.numpy(), steps=steps,
                       stats=convert.to_jax_layout(st, cfg_t),
                       caches=convert.to_jax_layout(caches, cfg_t),
                       prefill_caches=prefill_caches)
    return out


def check_serve(ref, port):
    """Prefill statistics and caches bit for bit, logits within 2e-6, the
    port's backends bit-equal."""
    for bk in ("simulated", "fused"):
        got = port[bk]
        assert_trees_equal(ref["stats"], got["stats"], f"{bk} stats")
        assert_trees_equal(ref["caches"], got["caches"], f"{bk} caches")
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=0,
                                   atol=2e-6, err_msg=f"{bk} prefill")
        for i, (a, b) in enumerate(zip(ref["steps"], got["steps"])):
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-6,
                                       err_msg=f"{bk} decode step {i}")
    sim, fus = port["simulated"], port["fused"]
    np.testing.assert_array_equal(sim["logits"], fus["logits"])
    for a, b in zip(sim["steps"], fus["steps"]):
        np.testing.assert_array_equal(a, b)
    assert_trees_equal(sim["stats"], fus["stats"], "backends")


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


def check_train_step(arch, seq: int, monkeypatch, lr=3e-3, batch=2):
    """One AdamW step from the reference's init state, batch and noise,
    the reference compiled as written: the loss within 1e-6 relative,
    every quant leaf bit for bit, every parameter within 1e-5 of its
    tensor's largest element but for at most 1e-3 of all elements, and
    those within their AdamW step's span of 2 lr; the port's backends
    bit-equal.  Returns the reference's quant tree's leaf names."""
    cfg_j, cfg_t = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    policy = JPolicy.w8a8g8(backend="simulated")
    init = _np(jax.jit(lambda k: jsteps.init_train_state(
        k, cfg_j, jadamw(weight_decay=0.0), policy))(jax.random.PRNGKey(0)))
    bt = _np(jdata.for_arch(cfg_j, seq_len=seq, global_batch=batch,
                            seed=0).batch(0))
    args = (jax.tree_util.tree_map(jnp.asarray, init),
            jax.tree_util.tree_map(jnp.asarray, bt))
    state, met = compile_as_written_bf16(jsteps.make_train_step(
        cfg_j, policy, jadamw(weight_decay=0.0), jsched.constant(lr)),
        *args)(*args)
    ref = _np(state)
    loss_r = float(met["loss"])
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)
    port = {}
    for bk in ("simulated", "fused"):
        opt = topt.adamw(weight_decay=0.0)
        st = convert.train_state_from_jax(init, cfg_t, opt, "cpu")
        step = tsteps.make_train_step(cfg_t, TPolicy.w8a8g8(backend=bk), opt,
                                      topt.constant(lr))
        st, m = step(st, _torch_batch(bt))
        port[bk] = (float(m["loss"]),
                    convert.to_jax_layout(st["quant"], cfg_t),
                    convert.params_to_jax(st["params"], cfg_t))
    for bk, (loss_t, quant_t, params_t) in port.items():
        assert abs(loss_t - loss_r) <= 1e-6 * abs(loss_r), (bk, loss_t,
                                                             loss_r)
        assert_trees_equal(ref["quant"], quant_t, f"{bk} quant")
        lr_, lt = _leaves(ref["params"]), _leaves(params_t)
        assert [p for p, _ in lr_] == [p for p, _ in lt], bk
        off = total = 0
        for (path, a), (_, b) in zip(lr_, lt):
            name = jax.tree_util.keystr(path)
            d = np.abs(b - a)
            assert d.max() <= 2 * lr * 1.001, (bk, name, d.max())
            if "['bk']" in name:
                continue
            off += int((d > 1e-5 * max(float(np.abs(a).max()), 1e-30))
                       .sum())
            total += d.size
        assert off <= 1e-3 * total, (bk, off, total)
    (ls, qs, ps), (lf, qf, pf) = port["simulated"], port["fused"]
    assert ls == lf
    assert_trees_equal(qs, qf, "backends quant")
    assert_trees_equal(ps, pf, "backends params")
    return [jax.tree_util.keystr(p) for p, _ in _leaves(ref["quant"])]


def decode_consistency(prefill, decode, cat, prompt: dict, s: int,
                       extra: int, steps: int = 2):
    """The reference's ``test_prefill_decode_consistency`` loop, for
    ``steps`` greedy steps: (max |d|, share outside rtol 2e-2 / atol
    2e-3) of the decode logits against a prefill of the extended prompt,
    worst over the steps; ``prefill`` / ``decode`` / ``cat`` are the
    package's."""
    logits, cache = prefill(prompt, s + extra + steps + 4)
    worst, outside = 0.0, 0.0
    for i in range(steps):
        tok, logits_dec, cache = decode(logits, s + i, cache)
        prompt = dict(prompt, tokens=cat(prompt["tokens"], tok))
        logits, _ = prefill(prompt, s + extra + steps + 4)
        a, b = np.asarray(logits_dec), np.asarray(logits)
        worst = max(worst, float(np.abs(a - b).max()))
        outside = max(outside, float(np.mean(
            np.abs(a - b) > 2e-3 + 2e-2 * np.abs(b))))
    return worst, outside


def reference_decode_consistency(arch, prompt_np: dict, s: int, extra: int):
    cfg = jconfigs.get_reduced(arch)
    params = jmodel.init_params(jax.random.PRNGKey(1), cfg)
    qs = jmodel.init_quant_state(cfg)
    policy = JPolicy.disabled()

    def prefill(prompt, cache_len):
        return jmodel.prefill(params, qs, prompt, cfg, policy,
                              cache_len=cache_len)

    def decode(logits, pos, cache):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        lg, cache = jmodel.decode_step(params, qs, tok,
                                       jnp.full((tok.shape[0],), pos,
                                                jnp.int32), cache, cfg,
                                       policy)
        return tok, lg, cache
    prompt = {k: jnp.asarray(v) for k, v in prompt_np.items()}
    return decode_consistency(prefill, decode,
                              lambda a, b: jnp.concatenate([a, b], 1),
                              prompt, s, extra)


def port_decode_consistency(arch, prompt_np: dict, s: int, extra: int,
                            dtype: str):
    cfg = dataclasses.replace(configs.get_reduced(arch), compute_dtype=dtype,
                              cache_dtype=dtype)
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    qs = tmodel.init_quant_state(cfg, device="cpu")
    policy = TPolicy.disabled()

    def prefill(prompt, cache_len):
        return tmodel.prefill(params, qs, prompt, cfg, policy,
                              cache_len=cache_len)

    def decode(logits, pos, cache):
        tok = torch.argmax(logits, -1)[:, None]
        lg, cache = tmodel.decode_step(params, qs, tok,
                                       torch.full((tok.shape[0],), pos),
                                       cache, cfg, policy)
        return tok, lg, cache
    return decode_consistency(prefill, decode,
                              lambda a, b: torch.cat([a, b], 1),
                              _torch_batch(prompt_np), s, extra)


def record_names_match(arch):
    """The port's telemetry records of an initial width-10 quant state
    carry the reference's site names, every one."""
    cfg_j, cfg_t = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jpol = JPolicy.w8a8g8(backend="simulated").with_telemetry()
    tpol = TPolicy.w8a8g8(backend="simulated").with_telemetry()
    rj = jtelemetry.collect(jmodel.init_quant_state(cfg_j, jpol),
                            skip_unvisited=False)
    rt = telemetry.collect(tmodel.init_quant_state(cfg_t, tpol, "cpu"),
                           skip_unvisited=False, cfg=cfg_t)
    assert sorted(rt) == sorted(rj)
    return sorted(rj)


# ---------------------------------------------------------------------------
# The config and the layout.
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    assert_configs_match(ARCH)
    assert configs.get(ARCH).family == "encdec"


def test_full_config_parameter_count():
    """0.878 B parameters (3.51 GB in fp32): untied 256206 x 1024 embed
    and head, 12 encoder and 12 decoder layers, ``enc_in`` 160 x 1024."""
    assert round(count_parameters(ARCH) / 1e9, 3) == 0.878


def test_convert_round_trip_with_the_encoder():
    """Params, quant state and caches, the encoder's stacked ``[2, ...]``
    leaves and ``enc_in`` / ``enc_norm`` included, to the port's
    per-layer trees and back bit for bit; the decoder caches carry the
    self ``kv`` and the cross ``xkv``."""
    trees, port = convert_round_trip(ARCH, cache_len=24)
    pt = port["params"]
    assert len(pt["encoder"]["layers"]) == 2
    assert set(pt["decoder"]["layers"][1]._names) == {
        "ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    np.testing.assert_array_equal(
        pt["encoder"]["layers"][1]["attn"]["wq"].numpy(),
        trees["params"]["encoder"]["blocks"]["b0"]["attn"]["wq"][1])
    np.testing.assert_array_equal(pt["enc_in"].numpy(),
                                  trees["params"]["enc_in"])
    assert set(port["quant"]) == {"decoder", "encoder", "enc_in", "head"}
    assert set(port["quant"]["decoder"]["layers"][0]) == {"attn", "xattn",
                                                           "mlp"}
    cache = port["cache"]["decoder"]["layers"][0]
    assert set(cache) == {"kv", "xkv"}
    assert cache["xkv"]["k"].shape == (2, 24, 4, 16)


def test_for_arch_gives_frames():
    """``frames [B, seq_len, frontend_dim]`` fp32 beside ``seq_len``
    tokens, correlated with the first token as the reference's."""
    cfg = configs.get_reduced(ARCH)
    b = data.for_arch(cfg, seq_len=24, global_batch=3, seed=0).batch(2)
    assert b["tokens"].shape == (3, 24)
    assert b["frames"].shape == (3, 24, cfg.frontend_dim)
    assert b["frames"].dtype == torch.float32
    again = data.for_arch(cfg, seq_len=24, global_batch=3, seed=0).batch(2)
    assert torch.equal(b["frames"], again["frames"])
    ref = jdata.for_arch(jconfigs.get_reduced(ARCH), seq_len=24,
                         global_batch=3).batch(2)
    assert set(ref) == set(b)


def test_decode_cache_layout():
    """Each xattn block carries the self ``kv`` of ``cache_len`` slots and
    the cross ``xkv`` of ``cfg.enc_len(cache_len)`` slots."""
    cfg = configs.get_reduced(ARCH)
    caches = tmodel.init_cache(cfg, 2, 40, "cpu")["decoder"]["layers"]
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert c["kv"]["k"].shape == (2, 40, 4, 16)
        assert c["xkv"]["k"].shape == (2, cfg.enc_len(40), 4, 16)


# ---------------------------------------------------------------------------
# The cross-attention layer.
# ---------------------------------------------------------------------------
def _spy(monkeypatch, mod, log):
    """Record the attention core's integer images and registers (through
    a host callback when ``mod`` is the reference's, traced under jit)."""
    orig = mod.attention_core_reference

    def record(sched, q, k, v, regs):
        log.append(dict(q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
                        regs=np.asarray(regs).reshape(-1), sched=sched))

    def spy(q, k, v, regs, kvlen, *, sched):
        if isinstance(q, torch.Tensor):
            record(sched, q, k, v, regs)
        else:
            jax.debug.callback(lambda *a: record(sched, *a), q, k, v, regs)
        return orig(q, k, v, regs, kvlen, sched=sched)
    monkeypatch.setattr(mod, "attention_core_reference", spy)


def reference_layer(params, sites, x, kv_x=None, **kw):
    """The reference's ``attention_layer`` under ``w8a8g8`` hindsight,
    compiled as written (bf16 excess precision off); numpy results."""
    policy = JPolicy.w8a8g8(backend="simulated")

    def layer(p, st, xx, kx):
        y, s, _ = jattn.attention_layer(p, st, xx, kv_x=kx, policy=policy,
                                        seed=jnp.int32(5),
                                        step=jnp.int32(0), **kw)
        return y, s
    args = (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, sites),
            jnp.asarray(x, jnp.bfloat16),
            None if kv_x is None else jnp.asarray(kv_x, jnp.bfloat16))
    y, st = compile_as_written_bf16(layer, *args)(*args)
    return np.asarray(y, np.float32), _np(st)


def test_cross_attention_layer_matches_reference(monkeypatch):
    """``attention_layer`` with ``kv_x`` (mode ``cross``, no RoPE) under
    ``w8a8g8`` hindsight, bf16 inputs, against the reference compiled as
    written: the core's kernel (the schedule
    ``(64, 64)`` at ``(20, 132, 16)``: the last of three kv tiles holds 4
    rows) gets integer images bit-equal to the reference's, with zp_p
    0; ``y`` and every statistic bit for bit on both backends; the
    ``k`` site's ``act`` statistics are those of ``kv_x`` (its own
    quantization), the ``q`` site's those of ``x``."""
    d, nh, nkv, hd, sq = 64, 4, 4, 16, MS
    assert tuning.attention_block(sq, FRAMES, hd) == (64, 64)
    rng = np.random.default_rng(3)
    params = _np(jattn.init_attention(jax.random.PRNGKey(3), d, nh, nkv, hd,
                                      use_bias=True))
    sites = _np(jattn.init_attention_sites())
    x = rng.standard_normal((B, sq, d)).astype(np.float32)
    kv_x = 3.0 * rng.standard_normal((B, FRAMES, d)).astype(np.float32)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, mode="cross",
              rope_theta=None, q_chunk=16, kv_chunk=16)
    jlog, tlog = [], []
    _spy(monkeypatch, jattn_kernel, jlog)
    _spy(monkeypatch, tattn_kernel, tlog)
    yj, ref = reference_layer(params, sites, x, kv_x, **kw)
    (jcall,) = jlog
    assert jcall["sched"].bkv == 64 and jcall["sched"].skv == FRAMES
    assert jcall["regs"][3] == 0.0                       # zp_p
    for bk in ("simulated", "fused"):
        yt, st, _ = tattn.attention_layer(
            {k_: torch.from_numpy(v_) for k_, v_ in params.items()},
            jax.tree_util.tree_map(torch.from_numpy, sites),
            torch.from_numpy(x).to(torch.bfloat16),
            kv_x=torch.from_numpy(kv_x).to(torch.bfloat16),
            policy=TPolicy.w8a8g8(backend=bk), seed=5, step=0, **kw)
        tcall = tlog.pop()
        for name in ("q", "k", "v", "regs"):
            np.testing.assert_array_equal(tcall[name], jcall[name],
                                          f"{bk} image {name}")
        np.testing.assert_array_equal(yt.to(torch.float32).numpy(), yj, bk)
        assert_trees_equal(ref, convert._map(convert._to_numpy, st), bk)
    # the k site saw kv_x (3x the spread of x), the q site x
    k_act, q_act = ref["k"]["act"], ref["q"]["act"]
    assert k_act[1] - k_act[0] > 2.0 * (q_act[1] - q_act[0])
    np.testing.assert_array_equal(
        k_act[:2], [kv_x.astype(jnp.bfloat16).astype(np.float32).min(),
                    kv_x.astype(jnp.bfloat16).astype(np.float32).max()])


def test_cross_decode_runs_no_kv_projection_and_leaves_the_cache():
    """With a cache and ``kv_x=None`` (decode) no k/v projection runs, the
    k/v sites pass through as given, and the cache is returned as it
    was, bit for bit."""
    cfg = configs.get_reduced(ARCH)
    params = tmodel.init_params(cfg, seed=2, device="cpu")
    layer = params["decoder"]["layers"][0]["xattn"]
    sites = tmodel.init_quant_state(cfg, device="cpu")["decoder"][
        "layers"][0]["xattn"]
    cache = {"k": torch.randn(2, 10, 4, 16).to(torch.bfloat16),
             "v": torch.randn(2, 10, 4, 16).to(torch.bfloat16),
             "pos": torch.arange(10, dtype=torch.int32).expand(2, 10).clone()}
    before = {k: v.clone() for k, v in cache.items()}
    calls = []
    orig = tqlinear.qdense_pre

    def spy(*a, **k):
        calls.append(k["einsum_spec"])
        return orig(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tqlinear, "qdense_pre", spy)
        y, st, out = tattn.attention_layer(
            layer, sites, torch.randn(2, 1, 64).to(torch.bfloat16),
            n_heads=4, n_kv=4, head_dim=16, mode="cross", rope_theta=None,
            positions=torch.full((2, 1), 30), cache=cache,
            policy=TPolicy.w8a8g8(backend="fused"), seed=8, step=0)
    assert calls == ["bsd,dkgh->bskgh"]
    assert st["k"] is sites["k"] and st["v"] is sites["v"]
    for k, v in before.items():
        assert torch.equal(out[k], v), k
    assert y.shape == (2, 1, 64)


# ---------------------------------------------------------------------------
# The model: prefill and decode against the reference.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_case():
    """Reduced seamless, 20-token prompts and 132 frames into a cache of
    24: the cross cache is a ring that keeps the last 24 frames."""
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    rng = np.random.default_rng(5)
    prompt = {"tokens": rng.integers(0, cfg_j.vocab, (B, MS)).astype(
        np.int32),
        "frames": rng.standard_normal((B, FRAMES, cfg_j.frontend_dim))
        .astype(np.float32)}
    nxt = rng.integers(0, cfg_j.vocab, (GEN, B, 1)).astype(np.int32)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    ref = reference_serve(cfg_j, params_j, quant_j, prompt, MS + GEN, nxt,
                          MS)
    calls = []
    orig = ttransformer.apply_stack

    def spy(*a, **k):
        calls.append(k["pattern"])
        return orig(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttransformer, "apply_stack", spy)
        port = port_serve(cfg_t, params_j, quant_j, prompt, MS + GEN, nxt,
                          MS)
    return dict(ref=ref, port=port, calls=calls)


def test_encdec_prefill_and_decode_bit_equal_to_reference(serve_case):
    """Every site's prefill statistics (``enc_in``, the encoder's, the
    decoder's self and cross sites) and the caches after 4 decode steps
    bit for bit; logits within 2e-6."""
    names = [jax.tree_util.keystr(p)
             for p, _ in _leaves(serve_case["ref"]["stats"])]
    assert any("['encoder']" in n for n in names)
    assert any("['enc_in']['act']" in n for n in names)
    assert any("['xattn']['core']['p']" in n for n in names)
    check_serve(serve_case["ref"], serve_case["port"])


def test_cross_cache_ring_keeps_the_last_frames(serve_case):
    """132 frames into ``enc_len(24)`` = 24 slots: the reference and the
    port keep frames 108-131 at slots ``pos % 24``, and the decode steps
    leave ``xkv`` bit-identical to what the prefill wrote."""
    ref = serve_case["ref"]["caches"]["decoder"]["blocks"]["b0"]["xkv"]
    pos = ref["pos"][0]                                   # [B, 24]
    np.testing.assert_array_equal(
        np.sort(pos, axis=-1),
        np.broadcast_to(np.arange(FRAMES - 24, FRAMES), (B, 24)))
    np.testing.assert_array_equal(pos[0] % 24, np.arange(24))
    for bk in ("simulated", "fused"):
        got = serve_case["port"][bk]
        for j in range(2):
            a = got["prefill_caches"]["decoder"]["blocks"]["b0"]["xkv"]
            b = got["caches"]["decoder"]["blocks"]["b0"]["xkv"]
            assert_trees_equal(a, b, f"{bk} xkv")


def test_encdec_decode_runs_the_decoder_only(serve_case):
    """The encoder stack runs once per prefill and never in decode."""
    enc, dec = ("enc",), ("xattn",)
    per_backend = [enc, dec] + [dec] * GEN
    assert serve_case["calls"] == per_backend * 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_decode_consistency_in_both_packages(dtype):
    """Decode after a prefill of 16 tokens and 16 frames against a
    prefill of the extended prompt, 2 greedy steps.  The reference
    (bf16, its own config) meets its tolerance rtol 2e-2, atol 2e-3:
    recorded here, as its own test leaves this family out (observed: max
    |d| 0, decode equals the re-prefill).  The port in bf16 within the
    same tolerance (observed 0); in fp32 within 1e-5 (observed
    1.4e-6)."""
    rng = np.random.default_rng(7)
    cfg = jconfigs.get_reduced(ARCH)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
              "frames": rng.standard_normal((2, 16, cfg.frontend_dim))
              .astype(np.float32)}
    worst, outside = port_decode_consistency(ARCH, prompt, 16, 0, dtype)
    if dtype == "float32":
        assert worst <= 1e-5
        return
    assert outside == 0.0, worst
    worst_r, outside_r = reference_decode_consistency(ARCH, prompt, 16, 0)
    assert outside_r == 0.0, worst_r


# ---------------------------------------------------------------------------
# Training, telemetry and the drivers.
# ---------------------------------------------------------------------------
def test_encdec_train_step_matches_jax_simulated(monkeypatch):
    """One W8A8G8 AdamW step on the reference's batch (32 frames, 32
    tokens): the encoder's and ``enc_in``'s gradient sites among the
    quant leaves held."""
    names = check_train_step(ARCH, 32, monkeypatch)
    assert any("['encoder']" in n and "['grad']" in n for n in names)
    assert any("['enc_in']['grad']" in n for n in names)


def test_telemetry_record_names_match_reference():
    names = record_names_match(ARCH)
    assert any(n.startswith("encoder/blocks/b0/attn/") for n in names)
    assert "enc_in/act" in names


def test_serve_and_train_drivers_run_encdec_on_cpu():
    run = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    assert run.tokens.shape == (2, 4)
    assert run.inputs["frames"].shape == (2, 16, 16)
    assert run.cache_len == 16 and run.pos0 == 12
    assert torch.isfinite(run.prefill_logits).all()
    t = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(t.losses) == 2 and np.all(np.isfinite(t.losses))
