"""Port vs reference: the dense family's configs (starcoder2-7b,
command-r-35b, nemotron-4-340b) and the attention core at head dims above
128, at reduced size on the CPU (bf16 ``gelu``: ``test_torch_gelu.py``).

The reference's ``init_params`` are carried across with
``repro_torch.convert``; prompts are made with numpy from a seed.

Tolerances, stated per test:
  * the reduced configs in fp32 compute (hindsight on the port's fused
    backend, whose kernels run their plain versions here, and fp32),
    against the reference compiled as written
    (``tests/test_torch_conv.py::jit_as_written``): the serve test's 1e-4
    (an ulp of exp/tanh/rsqrt between XLA and PyTorch may move an
    activation one 8-bit level; observed <= 4e-6).  Plain ``jax.jit``
    contracts fp32 seams and flips 8-bit levels (nemotron's logits by
    4e-2);
  * the attention core at hd 192 / 256: ``tests/test_torch_kernels.py``'s
    (``m`` and min/max/clip/n exact, the rest within 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import int8_attention as jkattn
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import int8_attention as tkattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tuning as ttuning
from repro_torch.models import model as tmodel

from test_torch_conv import jit_as_written
from test_torch_kernels import _attn_inputs, _eq

ARCHS = ["starcoder2-7b", "command-r-35b", "nemotron-4-340b"]
B, S, GEN = 2, 32, 2


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


# ---------------------------------------------------------------------------
# The configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get", "get_reduced"):
        cj, ct = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), (get, f.name)


def _reduced(arch, compute_dtype):
    """The reduced config with its fp paths in reach: S 32 is past
    starcoder2-7b's window of 16 (``_local_attn``, a wrapped ring cache)
    and past a dense_attn_max lowered to 16 on the other two
    (``_chunked_attn`` over 16 x 16 blocks)."""
    kw = dict(compute_dtype=compute_dtype, cache_dtype=compute_dtype)
    if arch != "starcoder2-7b":
        kw["dense_attn_max"] = 16
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw),
            dataclasses.replace(tconfigs.get_reduced(arch), **kw))


def _serve(arch, compute_dtype, policy):
    """Prefill (with stats) and ``GEN`` decode steps of both packages on
    the reference's parameters; the port's hindsight runs on ``fused``."""
    cfg_j, cfg_t = _reduced(arch, compute_dtype)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg_j.vocab, (GEN, B, 1)).astype(np.int32)
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    pj = (JPolicy.disabled() if policy == "fp32"
          else JPolicy.w8a8g8(backend="simulated"))
    pt = TPolicy.disabled() if policy == "fp32" else TPolicy.w8a8g8(
        backend="fused")

    def prefill(p, q, b):
        return jmodel.prefill(p, q, b, cfg_j, pj, cache_len=S + GEN,
                              return_stats=True)

    def decode(p, q, t, ps, c):
        return jmodel.decode_step(p, q, t, ps, c, cfg_j, pj)
    ref = {"dlogits": []}
    ref["logits"], caches, stats = jit_as_written(
        prefill, params_j, quant_j, {"tokens": jnp.asarray(tokens)})
    ref["stats"] = _np(stats)
    for i in range(GEN):
        pos = jnp.full((B,), S + i, jnp.int32)
        lg, caches = jit_as_written(decode, params_j, quant_j,
                                    jnp.asarray(nxt[i]), pos, caches)
        ref["dlogits"].append(lg)
    ref = _np(ref)
    params_t = convert.params_from_jax(_np(params_j), cfg_t, "cpu")
    quant_t = convert.from_jax_layout(_np(quant_j), cfg_t, "cpu")
    got = {"dlogits": []}
    logits, caches, stats = tmodel.prefill(
        params_t, quant_t, {"tokens": torch.from_numpy(tokens).long()}, cfg_t,
        pt, cache_len=S + GEN, return_stats=True)
    got["logits"] = logits.float().numpy()
    got["stats"] = convert.to_jax_layout(stats, cfg_t)
    for i in range(GEN):
        pos = torch.full((B,), S + i, dtype=torch.long)
        lg, caches = tmodel.decode_step(params_t, quant_t,
                                        torch.from_numpy(nxt[i]).long(), pos,
                                        caches, cfg_t, pt)
        got["dlogits"].append(lg.float().numpy())
    return cfg_t, ref, got


@pytest.mark.parametrize("policy", ["hindsight", "fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_serves_like_jax(arch, policy):
    cfg_t, ref, got = _serve(arch, "float32", policy)
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["logits"], ref["logits"], **close)
    for i in range(GEN):
        np.testing.assert_allclose(got["dlogits"][i], ref["dlogits"][i],
                                   err_msg=f"decode {i}", **close)
    lr, lt = _leaves(ref["stats"]), _leaves(got["stats"])
    assert [p for p, _ in lr] == [p for p, _ in lt]
    for (path, a), (_, b) in zip(lr, lt):
        what = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a[..., 2], b[..., 2], err_msg=what)
        np.testing.assert_allclose(b, a, err_msg=what, **close)
    if arch == "command-r-35b":
        assert "head" not in convert.params_to_jax(
            convert.params_from_jax(
                _np(jmodel.init_params(jax.random.PRNGKey(4), cfg_t)),
                cfg_t, "cpu"), cfg_t)


# ---------------------------------------------------------------------------
# The attention core above hd 128.
# ---------------------------------------------------------------------------
WIDE_CASES = [
    # mode, sq, skv, groups, hd, window, kv_len, block[, zero points]
    ("causal", 40, 40, 3, 192, 0, None, (16, 16)),
    ("sliding", 48, 48, 2, 256, 20, 40, (16, 16), (117.7, -0.1, 1.0, 23.0)),
    ("causal", 24, 24, 1, 160, 0, 21, (8, 8), (125.5, -0.1, 1.0, 0.6)),
]


@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: f"{c[0]}-{c[4]}")
def test_attention_plain_wide_head_dims_match_jax(case, monkeypatch):
    """The port's plain attention core (the CUDA kernel's oracle) against
    the reference's Pallas kernel in interpret mode, at hd 160-256."""
    mode, sq, skv, groups, hd, window, kv_len, block = case[:8]
    monkeypatch.setenv("REPRO_ATTN_BLOCK", f"{block[0]},{block[1]}")
    bq, bkv = ttuning.attention_block(sq, skv, hd)
    kw = dict(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=groups,
              mode=mode, window=window, sm_scale=hd ** -0.5)
    q, k, v, regs = _attn_inputs(sq, skv, groups, hd, seed=sq + hd,
                                 **({"zps": case[8]} if len(case) > 8
                                    else {}))
    kvl = np.array([[skv if kv_len is None else kv_len]], np.int32)
    oj, mlj, psj = jops.int8_attention_fp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(regs),
        jnp.asarray(kvl), sched=jkattn.make_schedule(**kw))
    ot, mlt, pst = tops.int8_attention_fp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(regs), torch.from_numpy(kvl),
        sched=tkattn.make_schedule(**kw))
    mlj, psj = np.array(mlj), np.array(psj)
    _eq(mlj[..., 0], mlt[..., 0], "m")
    _eq(psj[..., :4], pst[..., :4], "min/max/clip/n")
    np.testing.assert_allclose(mlj[..., 1], mlt[..., 1].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(psj[..., 4:], pst[..., 4:].numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("hd, ok", [(128, True), (144, True), (192, True),
                                    (256, True), (100, True), (200, True),
                                    (272, False), (512, False)])
def test_kernel_tile_limits(hd, ok):
    """The CUDA kernel takes hd <= 256 (above 128 the wrapper pads hd to a
    multiple of 16), and says so (the plain version takes up to 512)."""
    sched = tkattn.make_schedule(sq=64, skv=64, hd=hd, bq=64, bkv=64,
                                 groups=1, mode="causal", sm_scale=1.0)
    if ok:
        tkattn.check_kernel_tiles(sched)
        want = hd if hd <= 128 else -(-hd // 16) * 16
        assert tkattn.kernel_head_dim(hd) == want
    else:
        with pytest.raises(ValueError, match="head_dim <= 256"):
            tkattn.check_kernel_tiles(sched)


@pytest.mark.parametrize("case", [("causal", 40, 40, 3, 200, 0, None,
                                   (16, 16)),
                                  ("sliding", 48, 48, 2, 250, 20, 40,
                                   (16, 16), (117.7, -0.1, 1.0, 23.0))],
                         ids=lambda c: f"{c[0]}-{c[4]}")
def test_attention_core_unchanged_by_hd_padding(case):
    """What the CUDA wrapper does at hd 200 and 250 (zero K and V columns
    up to the next multiple of 16), done to the plain core: out (cut
    back), (m, l) and the p-site statistics equal the unpadded core's bit
    for bit."""
    mode, sq, skv, groups, hd, window, kv_len, block = case[:8]
    q, k, v, regs = _attn_inputs(sq, skv, groups, hd, seed=sq + hd,
                                 **({"zps": case[8]} if len(case) > 8
                                    else {}))
    kvl = torch.tensor([[skv if kv_len is None else kv_len]],
                       dtype=torch.int32)
    hp = tkattn.kernel_head_dim(hd)
    assert hp % 16 == 0 and hp > hd
    out = []
    for d in (hd, hp):
        sched = tkattn.make_schedule(
            sq=sq, skv=skv, hd=d, bq=block[0], bkv=block[1], groups=groups,
            mode=mode, window=window, sm_scale=hd ** -0.5)
        qt, kt, vt = (torch.nn.functional.pad(torch.from_numpy(t),
                                              (0, d - hd))
                      for t in (q, k, v))
        out.append(tkattn.attention_core_reference(
            qt, kt, vt, torch.from_numpy(regs), kvl, sched=sched))
    (o, ml, ps), (op, mlp, psp) = out
    assert torch.equal(op[..., :hd], o) and not op[..., hd:].any()
    assert torch.equal(mlp, ml) and torch.equal(psp, ps)


@pytest.mark.parametrize("s, blocks, ok", [
    (200, (256, 128), True), (132, (256, 128), True), (256, (256, 128), True),
    (257, (257, 128), False), (256, (128, 256), False),
    (300, (300, 300), False)])
def test_kernel_q_block_limits(s, blocks, ok):
    """The tall instantiation takes bq up to 256 (the tuner's (256, 128)
    clamps to S = 132 or 200); bq 257 and bkv 256 still raise."""
    sched = tkattn.make_schedule(sq=s, skv=s, hd=128, bq=blocks[0],
                                 bkv=blocks[1], groups=1, mode="causal",
                                 sm_scale=1.0)
    if ok:
        tkattn.check_kernel_tiles(sched)
        assert sched.bq == min(blocks[0], s)
    else:
        with pytest.raises(ValueError, match="bq <= 256 and bkv <= 128"):
            tkattn.check_kernel_tiles(sched)
