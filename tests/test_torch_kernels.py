"""Port vs reference: the plain versions of the ported kernels against the
JAX package's Pallas kernels (interpret mode, the ``ops`` default) and its
``ref`` oracles.

  * fused_quantize: integer images and min/max bit-exact;
  * int8_matmul_fp: ``y`` and min/max bit-exact (exact int32 contraction,
    one fp32 multiply), at integer and non-integer zero points;
  * the CUDA kernels' operand staging (K and N padded to 16) leaves the
    plain product bit for bit; the build's library name
    follows the shared headers;
  * int8_matmul_fused: ``q`` and min/max bit-exact against
    ``ref.ref_int8_matmul_fused`` and the Pallas kernel, ties included;
  * attention: the schedule is identical; the running max ``m``, the
    min/max/clip/n statistics are exact; ``out``, ``l`` and err/sig are
    compared with a tolerance because XLA's and PyTorch's ``exp`` differ
    in the last ulp, which can flip a requantized probability by one
    level.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantSpec as JSpec
from repro.kernels import int8_attention as jattn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tuning as jtuning
from repro_torch.core.quant import QuantSpec as TSpec
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import int8_attention as tattn
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tuning as ttuning


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


# ---------------------------------------------------------------------------
# fused_quantize
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 70), (257, 300),
                                   (3, 5, 17)])
@pytest.mark.parametrize("sym", [False, True])
def test_fused_quantize_plain_matches_jax(shape, sym):
    rng = np.random.default_rng(sum(shape) + sym)
    x = (rng.standard_normal(shape) * 2.5).astype(np.float32)
    lo, hi = np.float32(-2.0), np.float32(3.0)  # clips both tails
    qj, mnj, mxj = jops.fused_quantize(jnp.asarray(x), lo, hi,
                                       spec=JSpec(bits=8, symmetric=sym))
    qt, mnt, mxt = tops.fused_quantize(torch.from_numpy(x), torch.tensor(lo),
                                       torch.tensor(hi),
                                       spec=TSpec(bits=8, symmetric=sym))
    assert qt.dtype == (torch.int8 if sym else torch.uint8)
    _eq(qj, qt, "q")
    _eq(mnj, mnt, "min")
    _eq(mxj, mxt, "max")


# ---------------------------------------------------------------------------
# int8_matmul_fp — the slice's four einsum specs, ragged M/N/K.
# ---------------------------------------------------------------------------
MM_CASES = [
    ("bsd,dkgh->bskgh", (2, 37, 70), (70, 2, 3, 11)),
    ("bsd,dkh->bskh", (3, 5, 130), (130, 2, 9)),
    ("bskgh,kghd->bsd", (2, 19, 2, 3, 21), (2, 3, 21, 45)),
    ("...k,kn->...n", (4, 29, 300), (300, 263)),
    ("...k,kn->...n", (4, 1, 64), (64, 33)),
]

# Every case at an integer zero point (what the paths give the kernel, since
# `scale_zero_point` rounds it) and at non-integer ones, where the shift
# round(128 - zp) is not 128 - zp.
MM_ZP_CASES = [c + (117.0,) for c in MM_CASES] + [
    c + (zp,) for c in MM_CASES for zp in (117.3, 0.5, 127.5)]


@pytest.mark.parametrize(
    "spec,xs,ws,zp", MM_ZP_CASES,
    ids=[f"{c[0]}-{c[1]}" + ("" if c[3] == 117.0 else f"-zp{c[3]}")
         for c in MM_ZP_CASES])
def test_int8_matmul_fp_plain_matches_jax(spec, xs, ws, zp):
    rng = np.random.default_rng(len(xs) * 100 + xs[-1])
    xq = rng.integers(0, 256, xs, dtype=np.uint8)
    wq = rng.integers(-127, 128, ws, dtype=np.int8)
    zp, alpha = np.float32(zp), np.float32(3.1e-4)
    plan_j = jops.plan_einsum(spec, len(xs), len(ws))
    plan_t = tops.plan_einsum(spec, len(xs), len(ws))
    assert (plan_j.x_perm, plan_j.w_perm, plan_j.y_perm) == \
        (plan_t.x_perm, plan_t.w_perm, plan_t.y_perm)
    yj, mnj, mxj = jops.int8_matmul_fp(jnp.asarray(xq), jnp.asarray(wq),
                                       zp, alpha, plan=plan_j)
    yt, mnt, mxt = tops.int8_matmul_fp(torch.from_numpy(xq),
                                       torch.from_numpy(wq),
                                       torch.tensor(zp), torch.tensor(alpha),
                                       plan=plan_t)
    assert tuple(yt.shape) == tuple(yj.shape)
    _eq(yj, yt, "y")
    _eq(mnj, mnt, "min")
    _eq(mxj, mxt, "max")


@pytest.mark.parametrize("k", [1, 16, 3001])
def test_int8_matmul_staged_operands_keep_the_product(k):
    """The CUDA kernels' operand staging (the weight K-major, K zero-padded
    to a multiple of 16 in both operands) changes no bit of the plain
    product, and that product is the reference's."""
    rng = np.random.default_rng(k)
    xq = rng.integers(0, 256, (3, 37, k), dtype=np.uint8)
    wq = rng.integers(-127, 128, (3, k, 29), dtype=np.int8)
    zp, alpha = torch.tensor(117.3), torch.tensor(3.1e-4)
    x, w = torch.from_numpy(xq), torch.from_numpy(wq)
    xk, wk = tmm.stage_operands(x, w)
    kp = -(-k // 16) * 16
    assert xk.shape == (3, 37, kp) and wk.shape == (3, 29, kp)
    assert xk.is_contiguous() and wk.is_contiguous()
    assert not xk[..., k:].any() and not wk[..., k:].any()
    assert torch.equal(wk[..., :k], w.transpose(-1, -2))
    staged = tmm.int8_matmul_fp_plain(xk, wk.transpose(-1, -2), zp, alpha)
    plain = tmm.int8_matmul_fp_plain(x, w, zp, alpha)
    for a, b in zip(staged, plain):
        assert torch.equal(a, b)
    plan = jops.plan_einsum("bmk,bkn->bmn", 3, 3)
    yj, mnj, mxj = jops.int8_matmul_fp(jnp.asarray(xq), jnp.asarray(wq),
                                       np.float32(117.3), np.float32(3.1e-4),
                                       plan=plan)
    _eq(yj, staged[0], "y")
    _eq(mnj, staged[1], "min")
    _eq(mxj, staged[2], "max")


def test_int8_transpose_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA int8"):
        tmm.weight_kmajor_cuda(torch.zeros((16, 8), dtype=torch.int8))


def test_kernel_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh, so an
    edited header never loads a stale library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(tbuild, "CSRC", tmp_path)
    first = tbuild.library_path("k")
    assert tbuild.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = tbuild.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert tbuild.library_path("k") not in (first, second)


# ---------------------------------------------------------------------------
# int8_matmul_fused — the paper's single-pass layer.
# ---------------------------------------------------------------------------
FUSED_SHAPES = [(1, 1, 1), (33, 70, 17), (96, 160, 80), (129, 300, 77),
                (64, 16, 96)]
FUSED_OUT = (-1.5, 2.0)      # the out grid's range: clips both tails


def _fused_inputs(m, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(0, 256, (m, k), dtype=np.uint8)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32) if bias else None
    # alpha ~ 1 / (sqrt(K) * std(x) * std(w)): y of unit order
    x_scale = np.float32(0.02)
    w_scale = np.float32(1.0 / (0.02 * 74.0 * 73.0 * np.sqrt(k)))
    return xq, wq, x_scale, w_scale, b


def _fused_jax(xq, wq, x_scale, x_zp, w_scale, b, lo, hi, sym):
    return jref.ref_int8_matmul_fused(
        jnp.asarray(xq), jnp.asarray(wq), jnp.float32(x_scale),
        jnp.float32(x_zp), jnp.float32(w_scale),
        None if b is None else jnp.asarray(b), jnp.float32(lo),
        jnp.float32(hi), JSpec(bits=8, symmetric=sym))


def _fused_torch(xq, wq, x_scale, x_zp, w_scale, b, lo, hi, sym):
    return tops.int8_matmul_fused(
        torch.from_numpy(xq), torch.from_numpy(wq), float(x_scale),
        float(np.float32(x_zp)), float(w_scale),
        None if b is None else torch.from_numpy(b), lo, hi,
        out_spec=TSpec(bits=8, symmetric=sym))


def _eq_fused(jout, tout, sym):
    assert tout[0].dtype == (torch.int8 if sym else torch.uint8)
    assert tuple(tout[0].shape) == tuple(jout[0].shape)
    _eq(jout[0], tout[0], "q")
    _eq(jout[1], tout[1], "min")
    _eq(jout[2], tout[2], "max")


@pytest.mark.parametrize("x_zp", [117.0, 117.3, 0.5])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("mkn", FUSED_SHAPES, ids=str)
def test_int8_matmul_fused_plain_matches_ref(mkn, sym, bias, x_zp):
    xq, wq, xs, ws, b = _fused_inputs(*mkn, bias, seed=sum(mkn) + bias)
    jout = _fused_jax(xq, wq, xs, x_zp, ws, b, *FUSED_OUT, sym)
    tout = _fused_torch(xq, wq, xs, x_zp, ws, b, *FUSED_OUT, sym)
    _eq_fused(jout, tout, sym)
    spec = TSpec(bits=8, symmetric=sym)
    if mkn[0] * mkn[2] > 100:           # the range clips both tails
        q = tout[0].to(torch.int32)
        assert (q == spec.int_min).any() and (q == spec.int_max).any()


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_int8_matmul_fused_plain_ties_match_ref(sym):
    """Power-of-two scales put half the bias images and 1/512 of the
    requantized values exactly on .5: both round half to even."""
    m, k, n = 64, 16, 96
    xq, wq, _, _, _ = _fused_inputs(m, k, n, False, seed=3)
    xs = ws = np.float32(2.0 ** -8)                  # alpha = 2**-16
    b = ((np.arange(n) - n // 2) + 0.5).astype(np.float32) * np.float32(
        2.0 ** -16)
    step = 2.0 ** -7                                 # out scale
    lo, hi = (-128 * step, 127 * step) if not sym else (-127 * step,
                                                        127 * step)
    jout = _fused_jax(xq, wq, xs, 117.0, ws, b, lo, hi, sym)
    tout = _fused_torch(xq, wq, xs, 117.0, ws, b, lo, hi, sym)
    _eq_fused(jout, tout, sym)
    v = (xq.astype(np.int64) - 117) @ wq.astype(np.int64) + np.round(
        b / np.float32(2.0 ** -16)).astype(np.int64)
    assert (v % 512 == 256).sum() > 0        # y / scale + zp on a tie


FUSED_PALLAS_CASES = [((33, 70, 17), False, True, 117.3),
                      ((129, 300, 77), True, False, 0.5),
                      ((64, 16, 96), False, False, 117.0),
                      ((1, 1, 1), True, True, 117.3),
                      ((96, 160, 80), False, True, 0.5),
                      ((96, 160, 80), True, True, 117.0)]


@pytest.mark.parametrize("mkn,sym,bias,x_zp", FUSED_PALLAS_CASES,
                         ids=[f"{c[0]}-{'sym' if c[1] else 'asym'}-"
                              f"{'bias' if c[2] else 'nobias'}-zp{c[3]}"
                              for c in FUSED_PALLAS_CASES])
def test_int8_matmul_fused_plain_matches_pallas(mkn, sym, bias, x_zp):
    """Against the reference's public op, its Pallas kernel in interpret
    mode (the block does not change its result)."""
    xq, wq, xs, ws, b = _fused_inputs(*mkn, bias, seed=sum(mkn) + bias)
    jout = jops.int8_matmul_fused(
        jnp.asarray(xq), jnp.asarray(wq), xs, np.float32(x_zp), ws,
        None if b is None else jnp.asarray(b), *FUSED_OUT,
        out_spec=JSpec(bits=8, symmetric=sym), block=(128, 128, 128))
    tout = tops.int8_matmul_fused(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.tensor(xs),
        torch.tensor(np.float32(x_zp)), torch.tensor(ws),
        None if b is None else torch.from_numpy(b),
        torch.tensor(FUSED_OUT[0]), torch.tensor(FUSED_OUT[1]),
        out_spec=TSpec(bits=8, symmetric=sym))
    _eq_fused(jout, tout, sym)


def test_int8_matmul_fused_cuda_wrapper_rejects_cpu_tensors():
    """The fused launcher refuses what is not on the card, and the op
    refuses operands on different devices (no silent fallback)."""
    x = torch.zeros((4, 8), dtype=torch.uint8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    one = torch.tensor(1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tmm.int8_matmul_fused_cuda(x, w, one, one, None,
                                   torch.tensor([1.0, 0.0]),
                                   TSpec(bits=8, symmetric=False))
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        tops.int8_matmul_fused(x, w, 1.0, 128.0, 1.0,
                               torch.zeros(3, device="meta"), -1.0, 1.0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
SCHED_CASES = [(1024, 1024, 128), (24, 24, 16), (40, 40, 8), (300, 300, 64),
               (1, 17, 16), (130, 70, 32)]


@pytest.mark.parametrize("sq,skv,hd", SCHED_CASES)
@pytest.mark.parametrize("mode,window", [("causal", 0), ("sliding", 24),
                                         ("sliding", 4096)])
def test_attention_block_and_schedule_match_jax(sq, skv, hd, mode, window):
    """The tile changes the results, so the port must pick the reference's
    (bq, bkv) and kv visitation plan."""
    blk = jtuning.attention_block(sq, skv, hd)
    assert ttuning.attention_block(sq, skv, hd) == tuple(blk)
    kw = dict(sq=sq, skv=skv, hd=hd, bq=blk[0], bkv=blk[1], groups=3,
              mode=mode, window=window, sm_scale=hd ** -0.5)
    sj, st = jattn.make_schedule(**kw), tattn.make_schedule(**kw)
    assert dataclasses.astuple(sj) == dataclasses.astuple(st)
    for i in range(st.nq):
        assert int(jattn._kv_block_base(i, sj)) == tattn._kv_block_base(i, st)


ATTN_CASES = [
    # mode, sq, skv, groups, hd, window, kv_len, block[, zero points
    # (zp_q, p_lo, p_hi, zp_p); default (131, 0, 1, 0)[, "oracle"]]
    ("causal", 24, 24, 3, 8, 0, None, (8, 8)),
    ("causal", 21, 21, 2, 16, 0, 17, (8, 8)),
    ("sliding", 40, 40, 2, 8, 12, None, (8, 8)),
    ("sliding", 29, 29, 1, 16, 9, None, (16, 8)),
    ("causal", 19, 19, 4, 12, 0, None, None),
    # Zero points off the integers and off zero: both packages truncate
    # zp_q and zp_p (astype int32) in the corrections and in lsum, and a
    # masked p = 0 quantizes to rint(zp_p).
    ("causal", 21, 21, 2, 16, 0, 17, (8, 8), (117.7, -0.1, 1.0, 23.0)),
    ("causal", 19, 19, 4, 12, 0, None, None, (125.5, -0.1, 1.0, 0.6)),
    ("causal", 24, 24, 3, 8, 0, 21, (8, 8), (125.5, -0.1, 1.0, 0.6)),
    ("sliding", 32, 32, 1, 16, 9, None, (16, 8), (125.5, 0.0, 1.0, 0.6)),
    # The one case held against the reference's pinned oracle instead of
    # the Pallas kernel: skv is not a multiple of bkv and zp_p is not an
    # integer.  Every masked entry then carries p_int - trunc(zp_p) = 1 into
    # P.V, and Pallas's interpret mode fills the last kv block past skv
    # with int8's minimum (-128) where the oracle (and the port) pad zeros.
    # The same zero points agree with the Pallas kernel when skv fills the
    # blocks (sliding-32 above) or when kv_len masks real rows (causal-24).
    ("sliding", 29, 29, 1, 16, 9, None, (16, 8), (125.5, 0.0, 1.0, 0.6),
     "oracle"),
]


def _attn_id(c):
    return f"{c[0]}-{c[1]}" + (f"-zp{c[8][0]}" if len(c) > 8 else "")


def _attn_inputs(sq, skv, groups, hd, seed, zb=2,
                 zps=(131.0, 0.0, 1.0, 0.0)):
    zp_q, p_lo, p_hi, zp_p = zps
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (zb * groups, sq, hd), dtype=np.uint8)
    k = rng.integers(-127, 128, (zb, skv, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (zb, skv, hd), dtype=np.int8)
    s_q, s_k, s_v = 0.021, 0.013, 0.017
    scale_p = np.float32(p_hi - p_lo) / np.float32(255.0)
    regs = np.array([[zp_q, hd ** -0.5 * s_q * s_k, scale_p, zp_p,
                      scale_p * s_v, p_lo, p_hi, 0.0]], np.float32)
    return q, k, v, regs


@pytest.mark.parametrize("case", ATTN_CASES, ids=_attn_id)
def test_attention_plain_matches_jax(case, monkeypatch):
    mode, sq, skv, groups, hd, window, kv_len, block = case[:8]
    if block is not None:
        monkeypatch.setenv("REPRO_ATTN_BLOCK", f"{block[0]},{block[1]}")
    bq, bkv = ttuning.attention_block(sq, skv, hd)
    kw = dict(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv, groups=groups,
              mode=mode, window=window, sm_scale=hd ** -0.5)
    q, k, v, regs = _attn_inputs(sq, skv, groups, hd, seed=sq + hd,
                                 **({"zps": case[8]} if len(case) > 8
                                    else {}))
    kvl = np.array([[skv if kv_len is None else kv_len]], np.int32)
    jfn = jattn.attention_core_reference if case[9:] == ("oracle",) \
        else jops.int8_attention_fp
    oj, mlj, psj = jfn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(regs),
        jnp.asarray(kvl), sched=jattn.make_schedule(**kw))
    ot, mlt, pst = tops.int8_attention_fp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(regs), torch.from_numpy(kvl),
        sched=tattn.make_schedule(**kw))
    mlj, psj = np.array(mlj), np.array(psj)
    # exact: running max (exact int32 scores x one fp32 multiply) and the
    # order-free statistics.
    _eq(mlj[..., 0], mlt[..., 0], "m")
    _eq(psj[..., :4], pst[..., :4], "min/max/clip/n")
    # tolerance: exp differs by an ulp between XLA and PyTorch, which can
    # move one requantized probability by one level (1/255 of the row max).
    np.testing.assert_allclose(mlj[..., 1], mlt[..., 1].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(psj[..., 4:], pst[..., 4:].numpy(), rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(jattn.reduce_pstats(jnp.asarray(psj)),
                    tattn.reduce_pstats(torch.from_numpy(psj))):
        _eq(a, b, "reduce_pstats")


def test_pallas_attention_pads_past_skv_with_int8_min(monkeypatch):
    """Why sliding-29 at zp_p 0.6 is held against the oracle: the Pallas
    kernel's out there is the oracle's on K and V padded past skv with
    int8's minimum (what Pallas's interpret mode fills a block past the
    array's end with), not with the zeros the oracle and the port pad."""
    mode, sq, skv, groups, hd, window, _, block, zps, _ = ATTN_CASES[-1]
    monkeypatch.setenv("REPRO_ATTN_BLOCK", f"{block[0]},{block[1]}")
    bq, bkv = ttuning.attention_block(sq, skv, hd)
    q, k, v, regs = _attn_inputs(sq, skv, groups, hd, seed=sq + hd, zps=zps)
    padded = -(-skv // bkv) * bkv
    assert padded != skv

    def run(fn, k, v):
        sched = jattn.make_schedule(sq=sq, skv=k.shape[1], hd=hd, bq=bq,
                                    bkv=bkv, groups=groups, mode=mode,
                                    window=window, sm_scale=hd ** -0.5)
        return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(regs),
                             jnp.asarray(np.array([[skv]], np.int32)),
                             sched=sched)[0])

    def pad(x, fill):
        y = np.full((x.shape[0], padded, hd), fill, np.int8)
        y[:, :skv] = x
        return y

    pallas = run(jops.int8_attention_fp, k, v)
    lo = np.iinfo(np.int8).min
    np.testing.assert_array_equal(
        pallas, run(jattn.attention_core_reference, pad(k, lo), pad(v, lo)))
    assert not np.array_equal(pallas, run(jattn.attention_core_reference,
                                          pad(k, 0), pad(v, 0)))


def _kernel_tree(v: np.ndarray) -> np.float32:
    """The CUDA kernel's err/sig association for power-of-two bkv, in
    float32: the tile zero-padded to 128 x 128; its rows, row = w + 8 j
    (row group w, mma row j), halved top bit first (j's bit 3 in-thread,
    its bits 2..0 across lanes, then the groups' bits 2..0), then the
    columns, top bit first."""
    bq, bkv = v.shape
    x = np.zeros((128, 128), np.float32)
    x[:bq, :bkv] = v
    r = x.reshape(16, 8, 128)        # [j, w, column]
    for _ in range(4):               # j's bits 3, 2, 1, 0
        half = r.shape[0] // 2
        r = r[:half] + r[half:]
    r = r[0]                         # [w, column]
    for _ in range(3):               # w's bits 2, 1, 0
        half = r.shape[0] // 2
        r = r[:half] + r[half:]
    c = r[0]
    for _ in range(7):               # the column bits 6..0
        half = c.shape[0] // 2
        c = c[:half] + c[half:]
    return c[0]


def _tree_tiles(bq, bkv, n, seed):
    """Tiles of non-negative float32 of spread magnitudes (like d^2 and
    p^2), so that the association decides the last bits."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-8.0, 0.0, (n, bq, bkv))
    return (rng.random((n, bq, bkv)) ** 3 * mag).astype(np.float32)


@pytest.mark.parametrize("bq,bkv", [(1, 1), (3, 2), (8, 8), (19, 16),
                                    (64, 64), (100, 32), (128, 128),
                                    (128, 4), (7, 128), (128, 1)])
def test_kernel_tree_matches_tree_sum_last2(bq, bkv):
    """For power-of-two bkv, the kernel's rows-then-columns tree with the
    row = w + 8 j mapping is the reference's flat pairwise-halving tree
    (_tree_sum_last2), bit for bit, in both packages."""
    tiles = _tree_tiles(bq, bkv, 12, seed=bq * 131 + bkv)
    ref_t = tattn._tree_sum_last2(torch.from_numpy(tiles)).numpy()
    ref_j = np.asarray(jattn._tree_sum_last2(jnp.asarray(tiles)))
    got = np.array([_kernel_tree(x) for x in tiles], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref_t.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), ref_j.view(np.int32))


def test_kernel_tree_differs_for_other_bkv():
    """For bkv not a power of two the flat tree pairs entries of different
    columns, so the rows-then-columns tree is not the reference's; the
    kernel takes the flat tree for such shapes."""
    tiles = _tree_tiles(19, 24, 40, seed=7)
    ref = tattn._tree_sum_last2(torch.from_numpy(tiles)).numpy()
    got = np.array([_kernel_tree(x) for x in tiles], np.float32)
    assert (got.view(np.int32) != ref.view(np.int32)).any()


def test_attention_cuda_wrapper_rejects_cpu_tensors():
    """A CPU tensor never reaches the kernel launcher, and the launcher
    refuses what is not on the card (no silent fallback)."""
    q, k, v, regs = _attn_inputs(8, 8, 1, 8, seed=0, zb=1)
    sched = tattn.make_schedule(sq=8, skv=8, hd=8, bq=8, bkv=8, groups=1,
                                mode="causal", sm_scale=8 ** -0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(regs),
                             torch.tensor([8]), sched=sched)
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        tops.fused_quantize(torch.zeros(3, device="meta"), 0.0, 1.0)
