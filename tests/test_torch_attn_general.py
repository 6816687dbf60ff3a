"""Port vs reference: the attention core at the tiles the CUDA kernel's
general instantiation runs (bkv in (128, 512], bq above 256, hd in (256,
512]), on the CPU.

The port's plain core (``attention_core_reference``: the kernel's oracle
on the card, and the simulated backend's core) against the reference's
``attention_core_reference`` (pure jnp, the same block schedule), on
inputs made with numpy from a seed.  Bounds as
``tests/test_torch_kernels.py`` states them: the running max ``m`` and
min/max/clip/n exact; ``l`` within 1e-5, ``out`` and err/sig within 1e-4
(exp differs by an ulp between XLA and PyTorch, which can move one
requantized probability by one level).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_attention as jattn
from repro_torch.kernels import int8_attention as tattn

from test_torch_kernels import _attn_inputs, _eq

CASES = [
    # mode, sq, skv, groups, hd, window, prefix, kv_len, (bq, bkv)[, zps]
    ("causal", 600, 600, 2, 64, 0, 0, None, (512, 256)),
    ("prefix", 520, 520, 1, 32, 0, 100, None, (128, 512)),
    ("sliding", 400, 400, 2, 320, 150, 0, None, (64, 256),
     (117.7, -0.1, 1.0, 23.0)),
    ("cross", 40, 530, 1, 512, 0, 0, 500, (32, 512),
     (125.5, 0.0, 1.0, 0.6)),
    ("causal", 530, 530, 1, 512, 0, 0, 520, (512, 512)),
    ("bidir", 300, 300, 2, 16, 0, 0, None, (300, 300)),
]


@pytest.mark.parametrize(
    "case", CASES, ids=lambda c: f"{c[0]}-hd{c[4]}-{c[8][0]}x{c[8][1]}")
def test_plain_core_at_general_tiles_matches_jax(case):
    mode, sq, skv, groups, hd, window, prefix, kv_len, (bq, bkv) = case[:9]
    kw = dict(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=groups,
              mode=mode, window=window, prefix_len=prefix,
              sm_scale=hd ** -0.5)
    sched = tattn.make_schedule(**kw)
    assert (sched.bq, sched.bkv) == (min(bq, sq), min(bkv, skv))
    assert tattn.uses_general(sched)
    q, k, v, regs = _attn_inputs(sq, skv, groups, hd, seed=sq + hd,
                                 zb=1, **({"zps": case[9]}
                                          if len(case) > 9 else {}))
    kvl = np.array([[skv if kv_len is None else kv_len]], np.int32)
    oj, mlj, psj = jattn.attention_core_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(regs),
        jnp.asarray(kvl), sched=jattn.make_schedule(**kw))
    ot, mlt, pst = tattn.attention_core_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(regs), torch.from_numpy(kvl), sched=sched)
    mlj, psj = np.array(mlj), np.array(psj)
    _eq(mlj[..., 0], mlt[..., 0], "m")
    _eq(psj[..., :4], pst[..., :4], "min/max/clip/n")
    np.testing.assert_allclose(mlj[..., 1], mlt[..., 1].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(psj[..., 4:], pst[..., 4:].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_fold_partials_over_a_q_blocks_ctas():
    """The wrapper's fold of the general instantiation's per-CTA partials
    ``[BH, nq, nsub, 6]``: min of mins, max of maxes, the counters and
    err/sig summed over each q block's CTAs."""
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.random((2, 3, 4, 6), dtype=np.float32))
    got = tattn.fold_partials(parts)
    assert got.shape == (2, 3, 6)
    assert torch.equal(got[..., 0], parts[..., 0].amin(-1))
    assert torch.equal(got[..., 1], parts[..., 1].amax(-1))
    for j in range(2, 6):
        assert torch.equal(got[..., j], parts[..., j].sum(-1))
