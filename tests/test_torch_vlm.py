"""Port vs reference: the VLM family (paligemma-3b: an image prefix of
``n_patches`` patch embeddings through ``patch_proj``, attended
bidirectionally under the prefix-LM mask, then the text) at reduced size
on the CPU.

The reference's ``init_params`` / train state are carried across with
``repro_torch.convert``; inputs are made with numpy from a seed.  The
reduced config has 2 layers, d 64, 4 q heads on 1 kv head of 16 (MQA,
G = 4) and 8 patches.  Tolerances as in ``test_torch_encdec.py``:
  * the prefix core in the attention layer, both backends against the
    reference compiled as written: the integer images, the output and
    every statistic bit for bit;
  * prefill and decode (at the true position: ``n_patches`` + the text
    length) against the reference compiled as written with bf16 excess
    precision off: statistics and caches bit for bit, logits within
    2e-6;
  * one train step: the loss within 1e-6 relative, quant leaves bit for
    bit, parameters within 1e-5 of each tensor's largest element but for
    at most 1e-3 of the elements (gradients at bf16 noise), those within
    2 lr;
  * decode against a re-prefill under ``QuantPolicy.disabled()``: the
    reference's rtol 2e-2, atol 2e-3 in bf16 (its own
    ``tests/test_models.py::test_prefill_decode_consistency`` case for
    this family), 1e-5 in fp32.
The serve driver's decode positions skip ``n_patches - gen`` positions
the prefill never filled, in the reference's driver and in the port's,
which mirrors it.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import int8_attention as jattn_kernel
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs, data
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import int8_attention as tattn_kernel
from repro_torch.kernels import tuning
from repro_torch.launch import serve, train
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel

from test_torch_encdec import (_np, _spy, assert_configs_match,
                               assert_trees_equal, check_serve,
                               check_train_step, convert_round_trip,
                               count_parameters, port_decode_consistency,
                               port_serve, record_names_match,
                               reference_decode_consistency, reference_layer,
                               reference_serve)

ARCH = "paligemma-3b"
B, TEXT, GEN = 2, 12, 4


def test_configs_match_reference():
    assert_configs_match(ARCH)
    cfg = configs.get(ARCH)
    assert cfg.family == "vlm" and cfg.n_patches == 256


def test_full_config_parameter_count():
    """2.511 B parameters (10.04 GB in fp32): the tied 257216 x 2048
    embedding, 18 GeGLU layers and ``patch_proj`` 1152 x 2048."""
    assert round(count_parameters(ARCH) / 1e9, 3) == 2.511


def test_convert_round_trip_with_patch_proj():
    trees, port = convert_round_trip(ARCH, cache_len=28)
    np.testing.assert_array_equal(port["params"]["patch_proj"].numpy(),
                                  trees["params"]["patch_proj"])
    assert set(port["quant"]) == {"decoder", "patch_proj", "head"}
    assert "head" not in port["params"]._names          # tied embeddings
    assert port["cache"]["decoder"]["layers"][1]["kv"]["k"].shape == (
        2, 28, 1, 16)


def test_for_arch_gives_patches():
    """``patches [B, n_patches, frontend_dim]`` beside ``seq_len -
    n_patches`` tokens."""
    cfg = configs.get_reduced(ARCH)
    b = data.for_arch(cfg, seq_len=20, global_batch=2, seed=0).batch(0)
    assert b["tokens"].shape == (2, 12)
    assert b["patches"].shape == (2, 8, cfg.frontend_dim)


@pytest.mark.parametrize("prefix_len", [8, 100])
def test_prefix_core_matches_reference(prefix_len, monkeypatch):
    """The attention layer under the prefix-LM mask at 132 positions, G =
    4 on one kv head, hindsight W8A8: the core (a (64, 64) schedule whose
    last kv tile holds 4 rows; ``prefix_len`` inside the first block and
    past it) gets the reference's integer images, with zp_p 0; ``y`` and
    every statistic bit for bit on both backends."""
    d, nh, nkv, hd, s = 64, 4, 1, 16, 132
    assert tuning.attention_block(s, s, hd) == (256, 128)
    monkeypatch.setenv("REPRO_ATTN_BLOCK", "64,64")
    rng = np.random.default_rng(prefix_len)
    params = _np(jattn.init_attention(jax.random.PRNGKey(4), d, nh, nkv, hd,
                                      use_bias=False))
    sites = _np(jattn.init_attention_sites())
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, mode="prefix",
              prefix_len=prefix_len, q_chunk=16, kv_chunk=16)
    jlog, tlog = [], []
    _spy(monkeypatch, jattn_kernel, jlog)
    _spy(monkeypatch, tattn_kernel, tlog)
    yj, ref = reference_layer(params, sites, x, **kw)
    (jcall,) = jlog
    assert jcall["sched"].mode == "prefix" and jcall["sched"].groups == 4
    assert jcall["sched"].bkv == 64 and jcall["regs"][3] == 0.0
    for bk in ("simulated", "fused"):
        yt, st, _ = tattn.attention_layer(
            {k_: torch.from_numpy(v_) for k_, v_ in params.items()},
            jax.tree_util.tree_map(torch.from_numpy, sites),
            torch.from_numpy(x).to(torch.bfloat16),
            policy=TPolicy.w8a8g8(backend=bk), seed=2, step=0, **kw)
        tcall = tlog.pop()
        for name in ("q", "k", "v", "regs"):
            np.testing.assert_array_equal(tcall[name], jcall[name],
                                          f"{bk} image {name}")
        np.testing.assert_array_equal(yt.to(torch.float32).numpy(), yj, bk)
        assert_trees_equal(ref, jax.tree_util.tree_map(
            lambda t: t.numpy(), st), bk)


@pytest.fixture(scope="module")
def serve_case():
    """Reduced paligemma: 8 patches and 12 text tokens (20 positions),
    then 4 decode steps at the true positions 20-23."""
    cfg_j, cfg_t = jconfigs.get_reduced(ARCH), configs.get_reduced(ARCH)
    rng = np.random.default_rng(6)
    prompt = {"tokens": rng.integers(0, cfg_j.vocab, (B, TEXT)).astype(
        np.int32),
        "patches": rng.standard_normal((B, cfg_j.n_patches,
                                        cfg_j.frontend_dim)).astype(
            np.float32)}
    nxt = rng.integers(0, cfg_j.vocab, (GEN, B, 1)).astype(np.int32)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    quant_j = jmodel.init_quant_state(cfg_j)
    filled = TEXT + cfg_j.n_patches
    args = (params_j, quant_j, prompt, filled + GEN, nxt, filled)
    return dict(ref=reference_serve(cfg_j, *args),
                port=port_serve(cfg_t, *args))


def test_vlm_prefill_and_decode_bit_equal_to_reference(serve_case):
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(serve_case["ref"]["stats"])]
    assert any("['patch_proj']['act']" in n for n in names)
    assert any("['attn']['core']['p']" in n for n in names)
    check_serve(serve_case["ref"], serve_case["port"])


def test_vlm_cache_holds_the_prefix(serve_case):
    """The self-attention cache holds the 8 patch positions, the 12 text
    positions and the 4 decoded ones, in the reference and the port."""
    ref = serve_case["ref"]["caches"]["decoder"]["blocks"]["b0"]["kv"]
    np.testing.assert_array_equal(
        ref["pos"][0], np.broadcast_to(np.arange(24), (B, 24)))
    for bk in ("simulated", "fused"):
        got = serve_case["port"][bk]["caches"]["decoder"]["blocks"]["b0"]
        np.testing.assert_array_equal(got["kv"]["pos"], ref["pos"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_decode_consistency_at_the_true_position(dtype):
    """The reference's own case (8 patches and 8 tokens, decode at
    position 16): both packages within rtol 2e-2, atol 2e-3 in bf16
    (observed max |d| 0); the port in fp32 within 1e-5."""
    rng = np.random.default_rng(8)
    cfg = jconfigs.get_reduced(ARCH)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
              "patches": rng.standard_normal(
                  (2, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)}
    worst, outside = port_decode_consistency(ARCH, prompt, 16, 8, dtype)
    if dtype == "float32":
        assert worst <= 1e-5
        return
    assert outside == 0.0, worst
    worst_r, outside_r = reference_decode_consistency(ARCH, prompt, 16, 8)
    assert outside_r == 0.0, worst_r


def test_vlm_train_step_matches_jax_simulated(monkeypatch):
    """One W8A8G8 AdamW step on the reference's batch (8 patches, 24
    tokens; the loss over the text only)."""
    names = check_train_step(ARCH, 32, monkeypatch)
    assert any("['patch_proj']['grad']" in n for n in names)


def test_telemetry_record_names_match_reference():
    assert "patch_proj/act" in record_names_match(ARCH)


def test_serve_driver_position_gap_in_both_packages(monkeypatch):
    """``serve --prompt-len 16 --gen 4`` on the reduced config: the text
    stream is 20 - 8 = 12 tokens, so the prefill fills positions 0-19,
    but both drivers size the cache 16 + 4 + 8 = 28 and decode from
    position 16 + 8 = 24: positions 20-23 are never filled, in the
    reference's driver and in the port's, which mirrors it."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "16", "--gen", "4"]
    seen = {"ref_pos": [], "port_pos": []}
    jprefill, jdecode = jmodel.prefill, jmodel.decode_step

    def jpf(params, quant, batch, cfg, policy, cache_len=None, **kw):
        seen["ref_prefill"] = (batch["tokens"].shape,
                               batch["patches"].shape, cache_len)
        return jprefill(params, quant, batch, cfg, policy,
                        cache_len=cache_len, **kw)

    def jdf(params, quant, token, pos, caches, cfg, policy):
        jax.debug.callback(lambda p: seen["ref_pos"].append(int(p[0])), pos)
        return jdecode(params, quant, token, pos, caches, cfg, policy)
    monkeypatch.setattr(jmodel, "prefill", jpf)
    monkeypatch.setattr(jmodel, "decode_step", jdf)
    ref_tokens = jserve.main(argv)
    tdecode = tmodel.decode_step

    def tdf(params, quant, token, pos, caches, cfg, policy):
        seen["port_pos"].append(int(pos[0]))
        return tdecode(params, quant, token, pos, caches, cfg, policy)
    monkeypatch.setattr(tmodel, "decode_step", tdf)
    run = serve.main(argv + ["--device", "cpu"])
    assert seen["ref_prefill"] == ((2, 12), (2, 8, 24), 28)
    assert tuple(run.inputs["tokens"].shape) == (2, 12)
    assert tuple(run.inputs["patches"].shape) == (2, 8, 24)
    assert run.cache_len == 28 and run.pos0 == 24
    assert seen["ref_pos"] == seen["port_pos"] == [24, 25, 26]
    assert np.asarray(ref_tokens).shape == tuple(run.tokens.shape) == (2, 4)


def test_train_driver_runs_vlm_on_cpu():
    t = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "24"])
    assert len(t.losses) == 2 and np.all(np.isfinite(t.losses))
