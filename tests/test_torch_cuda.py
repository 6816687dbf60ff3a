"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``; each test takes the ``card`` fixture, which
skips where there is no CUDA device (the decision is made inside the
fixture, never at import).  Run on the H100 with

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

This file imports no JAX: the machine with the card has none (hence
``--noconftest``: ``tests/conftest.py`` imports JAX).
"""
import pytest
import torch

from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import fused_quantize as fq
from repro_torch.kernels import int8_attention as attn
from repro_torch.kernels import int8_matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quantize as sq

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (257, 301), (4096, 96),
                                   (3, 5, 17)])
@pytest.mark.parametrize("sym", [False, True])
def test_fused_quantize_kernel_matches_plain(card, shape, sym):
    g = _gen(card, sum(shape))
    x = torch.randn(shape, generator=g, device=card) * 2.5
    views = (x, x.reshape(-1)[1:]) if x.numel() > 1 else (x,)
    for view in views:                       # aligned, and misaligned start
        spec = QuantSpec(bits=8, symmetric=sym)
        qp = ops._qparams(torch.tensor(-2.0, device=card),
                          torch.tensor(3.0, device=card), spec)
        qk, mnk, mxk = fq.fused_quantize_cuda(view, qp, spec)
        qr, mnr, mxr = fq.fused_quantize_plain(view, qp, spec)
        torch.cuda.synchronize()
        assert torch.equal(qk, qr)
        assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (257, 301), (4096, 256),
                                   (3, 5, 17)])
@pytest.mark.parametrize("sym", [False, True])
def test_stochastic_quantize_kernel_matches_plain(card, shape, sym):
    """Operand form: bit-exact images and min/max, aligned and misaligned
    starts, on a bf16-canonicalized input."""
    g = _gen(card, sum(shape) + 7)
    x = (torch.randn(shape, generator=g, device=card) * 2.5).to(
        torch.bfloat16).to(torch.float32)
    u = torch.rand(shape, generator=g, device=card)
    spec = QuantSpec(bits=8, symmetric=sym, stochastic=True)
    qp = ops._qparams(torch.tensor(-2.0, device=card),
                      torch.tensor(3.0, device=card), spec)
    views = ((x, u), (x.reshape(-1)[1:], u.reshape(-1)[1:])) \
        if x.numel() > 1 else ((x, u),)
    for xv, uv in views:
        qk, mnk, mxk = sq.stochastic_quantize_cuda(xv, qp, uv, spec)
        qr, mnr, mxr = sq.stochastic_quantize_plain(xv, qp, uv, spec)
        torch.cuda.synchronize()
        assert torch.equal(qk, qr)
        assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


def test_stochastic_quantize_onchip_statistics(card):
    """On-chip Philox form: unbiased, seed-dependent, no repeated tiles, and
    the same min/max as the operand form."""
    spec = QuantSpec(bits=8, symmetric=False, stochastic=True)
    g = _gen(card, 11)
    x = torch.randn((4096, 3072), generator=g, device=card)
    lo, hi = torch.aminmax(x)
    qp = ops._qparams(lo, hi, spec)
    q, mn, mx = ops.stochastic_quantize(x, lo, hi, None, spec=spec,
                                        on_chip_prng=True, seed=5)
    assert torch.equal(mn, lo) and torch.equal(mx, hi)
    err = (q.to(torch.float32) - qp[1]) * qp[0] - x
    tol = 4.0 * err.std() / err.numel() ** 0.5
    assert err.mean().abs() <= tol, (err.mean().item(), tol.item())
    q2, _, _ = ops.stochastic_quantize(x, lo, hi, None, spec=spec,
                                       on_chip_prng=True, seed=6)
    assert (q != q2).float().mean() > 0.2
    # A constant input at a half-level offset: each element rounds up iff
    # its u >= 0.5, so the image is the noise's top bit.
    c = torch.full((1024, 1024), 0.5, device=card)
    one = torch.tensor(1.0, device=card)
    qc, _, _ = ops.stochastic_quantize(c, torch.tensor(0.0, device=card),
                                       one * 255.0, None, spec=spec,
                                       on_chip_prng=True, seed=5)
    assert abs(qc.float().mean().item() - 0.5) < 0.01
    tiles = qc.reshape(16, 64, 16, 64).permute(0, 2, 1, 3).reshape(256, -1)
    assert torch.unique(tiles, dim=0).shape[0] == 256


# The tensor-core loop's edges: K below, at and off the 16-byte chunk and
# the 64-byte slab (the wrapper pads K to 16), one row or column, partial
# row and column tiles, three batch slices.
MM_EDGE_SHAPES = [(3, m, k, n) for k, mns in (
    (1, ((1, 1), (129, 77))), (16, ((4, 8), (129, 129))),
    (17, ((1, 77), (129, 8))), (31, ((4, 129), (129, 1))),
    (48, ((1, 8), (4, 77))), (3001, ((4, 1), (129, 129)))) for m, n in mns]


@pytest.mark.parametrize("zp", [117.0, 117.3, 0.5, 127.5])
@pytest.mark.parametrize("b,m,k,n", [(1, 4, 64, 33), (1, 130, 300, 263),
                                     (3, 37, 70, 129), (1, 256, 3072, 256)]
                         + MM_EDGE_SHAPES)
def test_int8_matmul_kernel_matches_plain(card, b, m, k, n, zp):
    g = _gen(card, m + k + n)
    x = torch.randint(0, 256, (b, m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (b, k, n), generator=g, device=card,
                      dtype=torch.int8)
    zp = torch.tensor(zp, device=card)
    alpha = torch.tensor(3.1e-4, device=card)
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


@pytest.mark.parametrize("zp", [117.0, 117.3])
@pytest.mark.parametrize("b,m,k,n", [(8, 32, 64, 64), (8, 276, 64, 128),
                                     (8, 4, 64, 64), (8, 552, 256, 176)],
                         ids=["C16", "G4xC69", "decode", "ragged-N"])
def test_int8_matmul_batched_experts_match_plain(card, b, m, k, n, zp):
    """The MoE experts' contraction on the kernel's batch dimension (B =
    experts, M = groups x capacity, not a multiple of 128), with empty
    capacity slots: rows of zeros (the zero value's image is the zero
    point) and rows of zero bytes."""
    g = _gen(card, b * m + k + n)
    x = torch.randint(0, 256, (b, m, k), generator=g, device=card,
                      dtype=torch.uint8)
    x[:, m // 2:m // 2 + 3] = round(zp)
    x[1:, -2:] = 0
    w = torch.randint(-127, 128, (b, k, n), generator=g, device=card,
                      dtype=torch.int8)
    zp = torch.tensor(zp, device=card)
    alpha = torch.tensor(3.1e-4, device=card)
    ops.reset_launch_counts()
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)
    assert ops.launch_counts()["int8_matmul_fp"] == 1


@pytest.mark.parametrize("b,k,n", [(3, 1, 1), (3, 16, 8), (3, 17, 77),
                                   (1, 31, 129), (3, 48, 1),
                                   (1, 3001, 77), (2, 3072, 256)])
def test_int8_transpose_kernel_matches_plain(card, b, k, n):
    """The weight's K-major image (K zero-padded to 16), ragged K and N
    and a misaligned start."""
    w = torch.randint(-127, 128, (b, k, n + 1), generator=_gen(card, k + n),
                      device=card, dtype=torch.int8)
    ops.reset_launch_counts()
    for view in (w[..., :n].contiguous(), w.reshape(-1)[1:b * k * n + 1]
                 .reshape(b, k, n)):
        assert torch.equal(mm.weight_kmajor_cuda(view),
                           mm.weight_kmajor_plain(view))
    assert ops.launch_counts()["int8_transpose"] == 2


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("m,k,n,x_zp", [(1, 1, 1, 117.0),
                                        (4093, 3001, 77, 117.3),
                                        (257, 16, 96, 0.5),
                                        (4, 3072, 256, 117.0),
                                        (4, 1, 8, 117.3),
                                        (129, 16, 77, 0.5),
                                        (1, 17, 129, 127.5),
                                        (4, 31, 1, 117.0),
                                        (129, 48, 129, 117.3),
                                        (4, 3001, 77, 127.5),
                                        (129, 17, 8, 117.0),
                                        (1, 48, 77, 0.5),
                                        (129, 3001, 1, 0.5)])
def test_int8_matmul_fused_kernel_matches_plain(card, m, k, n, x_zp, sym,
                                                bias):
    """q and min/max bit-exact at ragged shapes (K below, at and off the
    16-byte chunk and the 64-byte slab, M or N = 1, partial tiles), both
    out grids, with and without a bias; the range clips."""
    g = _gen(card, m + k + n)
    x = torch.randint(0, 256, (m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=card,
                      dtype=torch.int8)
    b = torch.randn((n,), generator=g, device=card) * 0.5 if bias else None
    alpha = torch.tensor(1.0 / (74.0 * 73.0 * k ** 0.5), device=card)
    spec = QuantSpec(bits=8, symmetric=sym)
    qp = ops._qparams(torch.tensor(-1.5, device=card),
                      torch.tensor(2.0, device=card), spec)
    zp = torch.tensor(x_zp, device=card)
    qk, mnk, mxk = mm.int8_matmul_fused_cuda(x, w, zp, alpha, b, qp, spec)
    qr, mnr, mxr = mm.int8_matmul_fused_plain(x, w, zp, alpha, b, qp, spec)
    torch.cuda.synchronize()
    assert qk.dtype == spec.storage_dtype
    assert torch.equal(qk, qr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_int8_matmul_fused_kernel_ties_match_plain(card, sym):
    """Power-of-two scales: bias images and requantized values on .5 ties
    round half to even in both versions."""
    m, k, n = 1000, 16, 96
    g = _gen(card, 5)
    x = torch.randint(0, 256, (m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=card,
                      dtype=torch.int8)
    alpha = torch.tensor(2.0 ** -16, device=card)
    b = (torch.arange(n, device=card) - n // 2 + 0.5) * alpha
    step = 2.0 ** -7
    lo = -127 * step if sym else -128 * step
    spec = QuantSpec(bits=8, symmetric=sym)
    qp = ops._qparams(torch.tensor(lo, device=card),
                      torch.tensor(127 * step, device=card), spec)
    zp = torch.tensor(117.0, device=card)
    qk, mnk, mxk = mm.int8_matmul_fused_cuda(x, w, zp, alpha, b, qp, spec)
    qr, mnr, mxr = mm.int8_matmul_fused_plain(x, w, zp, alpha, b, qp, spec)
    torch.cuda.synchronize()
    assert torch.equal(qk, qr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


def test_int8_matmul_fused_op_launches_the_kernel(card):
    """A CUDA tensor given to the public op launches the kernel."""
    x = torch.randint(0, 256, (64, 32), device=card, dtype=torch.uint8)
    w = torch.randint(-127, 128, (32, 16), device=card, dtype=torch.int8)
    ops.reset_launch_counts()
    q, _, _ = ops.int8_matmul_fused(x, w, 0.02, 117.0, 0.001, None, -1.0,
                                    1.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["int8_matmul_fused"] == 1
    assert ops.launch_counts()["int8_transpose"] == 1
    assert q.is_cuda and q.shape == (64, 16) and q.dtype == torch.uint8


ATTN_CASES = [
    # mode, sq, skv, groups, hd, window, prefix, kv_len, (bq, bkv)[, zero
    # points (zp_q, p_lo, p_hi, zp_p); default (131, 0, 1, 0)]
    ("causal", 24, 24, 3, 8, 0, 0, None, (8, 8)),
    ("causal", 200, 200, 2, 64, 0, 0, 170, (128, 128)),
    ("sliding", 300, 300, 2, 32, 100, 0, None, (64, 64)),
    ("sliding", 256, 256, 12, 128, 4096, 0, None, (128, 128)),
    # qwen2-moe's prefill tile: MHA (G = 1), causal, hd 128
    ("causal", 256, 256, 1, 128, 0, 0, None, (128, 128)),
    ("prefix", 40, 40, 1, 16, 0, 13, None, (16, 8)),
    ("cross", 33, 70, 2, 12, 0, 0, 61, (16, 32)),
    # The prefill tile with zp_q off the integers and p's grid [-0.1, 1.0]
    # (zp_p 23): the zero points come back as -trunc(zp) * row/col sums.
    ("sliding", 256, 256, 12, 128, 4096, 0, None, (128, 128),
     (117.7, -0.1, 1.0, 23.0)),
    # Non-integer zp_p: masked entries quantize to rint(0.6) = 1, and
    # trunc(0.6) = 0 comes off (125.5: rint(128 - zp) - 128 would be -126).
    ("causal", 200, 200, 2, 64, 0, 0, 170, (128, 128),
     (125.5, 0.0, 1.0, 0.6)),
    # bkv not a power of two: the flat err/sig tree, with byte staging
    # (hd 12) and with cp.async staging (hd 64, bkv 48).
    ("causal", 19, 19, 4, 12, 0, 0, None, (128, 128), (125.5, 0.0, 1.0, 0.6)),
    ("sliding", 96, 96, 2, 64, 40, 0, None, (32, 48),
     (117.7, -0.1, 1.0, 23.0)),
]


def _attn_id(c):
    return f"{c[0]}-{c[1]}" + (f"-zp{c[9][0]}" if len(c) > 9 else "")


@pytest.mark.parametrize("case", ATTN_CASES, ids=_attn_id)
def test_attention_kernel_matches_plain(card, case):
    _hold_attention(card, case)


# Head dims above 128 (the wide kernel): nemotron-4-340b's hd 192 at its
# head layout (G = 12), hd 256 at G = 8, with the zero points off, a
# kv_len, the prefix mask, and bkv not a power of two (the flat tree).
WIDE_CASES = [
    ("causal", 256, 256, 12, 192, 0, 0, None, (128, 128)),
    ("sliding", 300, 300, 8, 256, 100, 0, None, (64, 64)),
    ("causal", 256, 256, 8, 256, 0, 0, 250, (128, 128),
     (117.7, -0.1, 1.0, 23.0)),
    ("prefix", 200, 200, 3, 160, 0, 70, None, (128, 64),
     (125.5, 0.0, 1.0, 0.6)),
    ("causal", 100, 100, 2, 192, 0, 0, 90, (128, 128),
     (117.7, -0.1, 1.0, 23.0)),
]


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: f"{_attn_id(c)}-hd{c[4]}")
def test_attention_kernel_wide_head_dims_match_plain(card, case):
    _hold_attention(card, case)


# q blocks of 129-256 rows (the tall instantiation): S = 129, 200 and 255
# under every mask mode at hd 64, 128 and 256, on the tuner's (256, 128)
# (bq clamps to S); cross also against 100 keys (bkv 100: the flat tree,
# narrow only: at hd 256 its buffer does not fit), and a kv_len.
TALL_CASES = [
    (mode, s, skv, groups, hd, 100 if mode == "sliding" else 0,
     70 if mode == "prefix" else 0, kvl, (256, 128)) + zp
    for hd, groups in ((64, 2), (128, 12), (256, 8))
    for s in (129, 200, 255)
    for mode, skv, kvl, zp in (
        ("causal", s, None, ()), ("sliding", s, None, ()),
        ("prefix", s, None, ((117.7, -0.1, 1.0, 23.0),)),
        ("cross", s + 45, s + 30, ()), ("bidir", s, None, ()))
] + [("cross", s, 100, 2, hd, 0, 0, None, (256, 128),
      (125.5, 0.0, 1.0, 0.6)) for hd in (64, 128) for s in (129, 200, 255)]


@pytest.mark.parametrize(
    "case", TALL_CASES,
    ids=lambda c: f"{_attn_id(c)}x{c[2]}-hd{c[4]}")
def test_attention_kernel_tall_q_blocks_match_plain(card, case):
    _hold_attention(card, case)


def test_attention_kernel_tall_is_the_tuners_pick(card):
    """The tuner's own block at S = 132 and 200 is (256, 128): the kernel
    runs it (bq 132 / 200) at hd 128 and 256."""
    from repro_torch.kernels import tuning
    for s, hd, groups in ((200, 128, 12), (132, 256, 8)):
        assert tuning.attention_block(s, s, hd) == (256, 128)
        _hold_attention(card, ("causal", s, s, groups, hd, 0, 0, None,
                               (256, 128)))


@pytest.mark.parametrize("hd, blocks, what", [
    (272, (128, 128), "head_dim"), (320, (128, 128), "head_dim"),
    (256, (100, 100), "shared memory"), (128, (257, 128), "bq <= 256"),
    (128, (256, 256), "bkv <= 128")])
def test_attention_kernel_refuses_what_it_cannot_take(card, hd, blocks,
                                                      what):
    """hd above 256, bq above 256, bkv above 128, and a wide tile whose
    flat err/sig buffer does not fit the card, raise with a message that
    names the limit (an hd in (128, 256] off the multiples of 16 runs
    padded: ``test_attention_kernel_pads_hd_off_16``)."""
    s = max(blocks)
    sched = attn.make_schedule(sq=s, skv=s, hd=hd, bq=blocks[0],
                               bkv=blocks[1], groups=1, mode="causal",
                               sm_scale=hd ** -0.5)
    q = torch.zeros((1, s, hd), dtype=torch.uint8, device=card)
    k = torch.zeros((1, s, hd), dtype=torch.int8, device=card)
    regs = torch.zeros(8, device=card)
    kvl = torch.tensor([s], device=card, dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        attn.attention_cuda(q, k, k, regs, kvl, sched=sched)


@pytest.mark.parametrize("case", [
    ("causal", 256, 256, 2, 200, 0, 0, None, (128, 128)),
    ("sliding", 300, 300, 4, 200, 96, 0, None, (64, 64)),
    ("bidir", 132, 132, 1, 136, 0, 0, None, (256, 128)),
    ("prefix", 200, 200, 8, 250, 0, 64, None, (128, 64))],
    ids=lambda c: f"{c[0]}-hd{c[4]}")
def test_attention_kernel_pads_hd_off_16(card, case):
    """Head dims in (128, 256] off the multiples of 16 run on the wide
    instantiation padded to the next one (zero K and V columns): held
    against the plain version at the unpadded hd as every other case."""
    _hold_attention(card, case)


def _hold_attention(card, case):
    mode, sq, skv, groups, hd, window, prefix, kv_len, (bq, bkv) = case[:9]
    zp_q, p_lo, p_hi, zp_p = case[9] if len(case) > 9 else (131.0, 0.0, 1.0,
                                                             0.0)
    g = _gen(card, sq + hd)
    zb = 2
    q = torch.randint(0, 256, (zb * groups, sq, hd), generator=g,
                      device=card, dtype=torch.uint8)
    k = torch.randint(-127, 128, (zb, skv, hd), generator=g, device=card,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (zb, skv, hd), generator=g, device=card,
                      dtype=torch.int8)
    scale_p = torch.tensor(p_hi - p_lo) / torch.tensor(255.0)
    regs = torch.tensor([zp_q, hd ** -0.5 * 0.021 * 0.013, float(scale_p),
                         zp_p, float(scale_p) * 0.017, p_lo, p_hi, 0.0],
                        device=card)
    kvl = torch.tensor([skv if kv_len is None else kv_len], device=card,
                       dtype=torch.int32)
    sched = attn.make_schedule(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv,
                               groups=groups, mode=mode, window=window,
                               prefix_len=prefix, sm_scale=hd ** -0.5)
    ops.reset_launch_counts()
    ok, mlk, psk = attn.attention_cuda(q, k, v, regs, kvl, sched=sched)
    assert ops.launch_counts()["int8_attention"] == 1
    orf, mlr, psr = attn.attention_core_reference(q, k, v, regs, kvl,
                                                  sched=sched)
    torch.cuda.synchronize()
    assert torch.equal(mlk[..., 0], mlr[..., 0])          # running max
    assert torch.equal(psk[..., :4], psr[..., :4])        # min/max/clip/n
    # expf vs torch.exp may differ in the last ulp and flip one p level.
    torch.testing.assert_close(ok, orf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mlk[..., 1], mlr[..., 1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(psk[..., 4:], psr[..., 4:], rtol=1e-4,
                               atol=1e-6)


def test_reduced_serve_on_card_uses_every_kernel(card):
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model
    cfg = configs.get_reduced("starcoder2-3b")
    params = model.init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 20), generator=_gen(card, 1),
                           device=card)
    logits = {}
    for backend in ("simulated", "fused"):
        policy = QuantPolicy.w8a8g8(backend=backend)
        ops.reset_launch_counts()
        logits[backend], _ = model.prefill(
            params, model.init_quant_state(cfg, device=card),
            {"tokens": tokens}, cfg, policy)
        counts = ops.launch_counts()
        if backend == "fused":      # the serving path has no gradient sites
            assert all(counts[k] > 0 for k in ("fused_quantize",
                                               "int8_transpose",
                                               "int8_matmul_fp",
                                               "int8_attention")), counts
            assert counts["stochastic_quantize"] == 0, counts
            assert counts["int8_matmul_fused"] == 0, counts
        else:
            assert not any(counts.values()), counts
    torch.testing.assert_close(logits["fused"], logits["simulated"],
                               rtol=1e-3, atol=1e-3)


def test_reduced_moe_serve_on_card_uses_every_kernel(card):
    """Reduced qwen2-moe prefill on the card: the experts' contractions
    launch the int8 matmul with B = 8 experts, the attention core runs at
    G = 1 (MHA), and the fused backend agrees with the simulated one
    (tolerance as the dense serve test's)."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model
    cfg = configs.get_reduced("qwen2-moe-a2.7b")
    params = model.init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=_gen(card, 3),
                           device=card)
    batches = []
    real = mm.int8_matmul_fp_cuda_staged

    def spy(xk, wk, zp, alpha, **kw):
        batches.append(xk.shape[0])
        return real(xk, wk, zp, alpha, **kw)
    mm.int8_matmul_fp_cuda_staged = spy
    try:
        logits = {}
        for backend in ("simulated", "fused"):
            ops.reset_launch_counts()
            logits[backend], _ = model.prefill(
                params, model.init_quant_state(cfg, device=card),
                {"tokens": tokens}, cfg, QuantPolicy.w8a8g8(backend=backend))
            counts = ops.launch_counts()
            if backend == "fused":
                assert all(counts[k] > 0 for k in (
                    "fused_quantize", "int8_transpose", "int8_matmul_fp",
                    "int8_attention")), counts
            else:
                assert not any(counts.values()), counts
    finally:
        mm.int8_matmul_fp_cuda_staged = real
    assert cfg.moe.n_experts in batches
    torch.testing.assert_close(logits["fused"], logits["simulated"],
                               rtol=1e-3, atol=1e-3)


def test_reduced_train_step_on_card_uses_every_kernel(card):
    """One forward + backward of the reduced model on the card: the fused
    backend launches every kernel of the path (the int8 matmul's weight
    transpose among them; not the fused layer kernel, which no model site
    calls), the simulated one none, and the two
    agree (tolerance: expf vs torch.exp may flip one requantized
    probability level, which the stochastic roundings below carry on)."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = configs.get_reduced("starcoder2-3b")
    state = steps.init_train_state(cfg, adamw(), seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=_gen(card, 2),
                           device=card)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "mask": torch.ones((2, 32), device=card)}
    out = {}
    for backend in ("simulated", "fused"):
        ops.reset_launch_counts()
        out[backend] = steps.forward_backward(
            cfg, QuantPolicy.w8a8g8(backend=backend), state["params"],
            model.init_quant_state(cfg, device=card), batch, 0, 0)
        counts = ops.launch_counts()
        if backend == "fused":
            assert all(counts[k] > 0 for k in ("fused_quantize",
                                               "stochastic_quantize",
                                               "int8_transpose",
                                               "int8_matmul_fp",
                                               "int8_attention")), counts
            assert counts["int8_matmul_fused"] == 0, counts
        else:
            assert not any(counts.values()), counts
    (ls, gs, _, _), (lf, gf, _, _) = out["simulated"], out["fused"]
    torch.testing.assert_close(lf, ls, rtol=1e-3, atol=0)
    for name, g in gs.items():
        if not name.endswith("attn.bk"):      # exact gradient is zero
            assert (gf[name] - g).norm() <= 5e-2 * g.norm(), name


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 14336), (4096, 14336, 4096)],
                         ids=["rwkv-key", "rwkv-value"])
def test_int8_matmul_rwkv_channel_mix_shapes_match_plain(card, m, k, n):
    """rwkv6-7b's channel mix at 4 x 1024 tokens: the key (d -> d_ff) and
    value (d_ff -> d) projections, bit-exact with their statistics."""
    g = _gen(card, m + k + n)
    x = torch.randint(0, 256, (1, m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (1, k, n), generator=g, device=card,
                      dtype=torch.int8)
    zp = torch.tensor(117.0, device=card)
    alpha = torch.tensor(2.3e-5, device=card)
    ops.reset_launch_counts()
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)
    assert ops.launch_counts()["int8_matmul_fp"] == 1


def test_reduced_rwkv_on_card_fused_matches_simulated(card):
    """The reduced rwkv6-7b on the card (2 layers, chunk 8; a 21-token
    prompt runs two chunks and a tail, then 3 decode steps through
    ``wkv_step``): the fused backend launches the quantizer, the weight
    transpose and the int8 matmul (8 per layer and forward) and no
    attention, the simulated one nothing; both give the same logits
    (tolerance as the dense serve test's); then one forward + backward,
    which adds the gradient quantizer, within the train test's bounds."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = configs.get_reduced("rwkv6-7b")
    params = model.init_params(cfg, seed=0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=_gen(card, 4),
                           device=card)
    logits = {}
    for backend in ("simulated", "fused"):
        policy = QuantPolicy.w8a8g8(backend=backend)
        quant = model.init_quant_state(cfg, device=card)
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, quant, {"tokens": tokens}, cfg,
                                  policy, cache_len=24)
        steps_out = [lg]
        for i in range(3):
            tok = torch.argmax(lg, dim=-1)[:, None]
            lg, cache = model.decode_step(
                params, quant, tok, torch.full((2,), 21 + i, device=card),
                cache, cfg, policy)
            steps_out.append(lg)
        counts = ops.launch_counts()
        if backend == "fused":
            assert counts["int8_matmul_fp"] == 8 * cfg.n_layers * 4, counts
            assert counts["fused_quantize"] > 0, counts
            assert counts["int8_transpose"] > 0, counts
            assert counts["int8_attention"] == 0, counts
            assert counts["stochastic_quantize"] == 0, counts
        else:
            assert not any(counts.values()), counts
        logits[backend] = torch.stack(steps_out)
    torch.testing.assert_close(logits["fused"], logits["simulated"],
                               rtol=1e-3, atol=1e-3)
    state = steps.init_train_state(cfg, adamw(), seed=0, device=card)
    batch = {"tokens": tokens[:, :16], "labels": tokens[:, 1:17],
             "mask": torch.ones((2, 16), device=card)}
    out = {}
    for backend in ("simulated", "fused"):
        ops.reset_launch_counts()
        out[backend] = steps.forward_backward(
            cfg, QuantPolicy.w8a8g8(backend=backend), state["params"],
            model.init_quant_state(cfg, device=card), batch, 0, 0)
        counts = ops.launch_counts()
        if backend == "fused":
            assert counts["stochastic_quantize"] > 0, counts
        else:
            assert not any(counts.values()), counts
    (ls, gs, _, _), (lf, gf, _, _) = out["simulated"], out["fused"]
    torch.testing.assert_close(lf, ls, rtol=1e-3, atol=0)
    for name, g in gs.items():
        assert (gf[name] - g).norm() <= 5e-2 * g.norm(), name


# MobileNetV2-tiny's conv shapes at a reduced batch (4 of 128):
# (what, x NHWC, w HWIO, stride, groups)
CONV_CASES = [
    ("stem", (4, 64, 64, 3), (3, 3, 3, 32), 1, 1),
    ("expand-1x1", (4, 64, 64, 24), (1, 1, 24, 144), 1, 1),
    ("depthwise", (4, 64, 64, 144), (3, 3, 1, 144), 1, 144),
    ("depthwise-s2", (4, 64, 64, 144), (3, 3, 1, 144), 2, 144),
]


@pytest.mark.parametrize("zp", [117.0, 117.3])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_fp_kernel_matches_plain(card, case, zp):
    """The conv site's int8 contraction on the card (im2col onto the int8
    matmul kernel) against its plain version on the CPU, bit for bit."""
    _, xs, ws, stride, groups = case
    g = _gen(card, sum(xs) + groups)
    x = torch.randint(0, 256, xs, generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, ws, generator=g, device=card,
                      dtype=torch.int8)
    plan = ops.plan_conv(xs, ws, stride, "SAME", 1, groups)
    zp_t, alpha = torch.tensor(zp), torch.tensor(2.3e-4)
    before = ops.launch_counts()
    yk, mnk, mxk = ops.int8_conv_fp(x, w, zp_t.to(card), alpha.to(card),
                                    plan=plan)
    after = ops.launch_counts()
    yr, mnr, mxr = ops.int8_conv_fp(x.cpu(), w.cpu(), zp_t, alpha, plan=plan)
    assert after["int8_matmul_fp"] == before["int8_matmul_fp"] + 1
    assert after["int8_transpose"] == before["int8_transpose"] + 1
    assert yk.is_cuda and yk.is_contiguous()
    assert torch.equal(yk.cpu(), yr)
    assert torch.equal(mnk.cpu(), mnr) and torch.equal(mxk.cpu(), mxr)


def test_int8_conv_fp_beyond_the_row_tiles_splits(card):
    """M = 2049 x 64 x 64 rows exceed the kernel's 65535 row tiles of 128:
    the wrapper splits M into two launches, and the result is the plain
    version's, bit for bit."""
    xs, ws = (2049, 64, 64, 1), (3, 3, 1, 1)
    g = _gen(card, 2049)
    x = torch.randint(0, 256, xs, generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, ws, generator=g, device=card,
                      dtype=torch.int8)
    plan = ops.plan_conv(xs, ws, 1, "SAME", 1, 1)
    zp, alpha = torch.tensor(131.0), torch.tensor(2.3e-4)
    before = ops.launch_counts()["int8_matmul_fp"]
    yk, mnk, mxk = ops.int8_conv_fp(x, w, zp.to(card), alpha.to(card),
                                    plan=plan)
    assert ops.launch_counts()["int8_matmul_fp"] == before + 2
    yr, mnr, mxr = ops.int8_conv_fp(x.cpu(), w.cpu(), zp, alpha, plan=plan)
    assert torch.equal(yk.cpu(), yr)
    assert torch.equal(mnk.cpu(), mnr) and torch.equal(mxk.cpu(), mxr)


# Every tile the int8 matmul instantiates, at the row counts the paths
# give it: decode (1, 4), one 16-row tile, the 64-row clamp (40), one full
# tile (128) and the MoE prefill's 552; K off the 128-byte slab, N off
# the 128-column tile.
TILE_MS = [1, 4, 16, 40, 128, 552]


def _tile_id(tile):
    return f"bm{tile[0]}"


@pytest.mark.parametrize("m", TILE_MS)
@pytest.mark.parametrize("tile", mm.MATMUL_TILES, ids=_tile_id)
def test_int8_matmul_every_tile_matches_plain(card, tile, m):
    """y, the requantized bytes and the min/max bit for bit against the
    plain versions on every tile; the launch runs the clamped row tile
    (``row_tile``) and counts it."""
    b, k, n = 3, 300, 263
    g = _gen(card, m + tile[0])
    x = torch.randint(0, 256, (b, m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (b, k, n), generator=g, device=card,
                      dtype=torch.int8)
    zp = torch.tensor(117.3, device=card)
    alpha = torch.tensor(3.1e-4, device=card)
    ops.reset_launch_counts()
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha, block=tile)
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)
    run = mm.row_tile(tile[0], m)
    assert ops.tile_launch_counts()[("int8_matmul_fp", run)] == 1
    if run != tile[0]:      # the tile itself, its rows past M zero-filled
        xk, wk = mm.stage_operands(x, w)
        yk, mnk, mxk = mm.int8_matmul_fp_cuda_staged(xk, wk, zp, alpha,
                                                     block=tile, clamp=False)
        torch.cuda.synchronize()
        assert torch.equal(yk, yr)
        assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)
        assert ops.tile_launch_counts()[("int8_matmul_fp", tile[0])] == 1
    bias = torch.randn((n,), generator=g, device=card) * 0.5
    for sym in (False, True):
        spec = QuantSpec(bits=8, symmetric=sym)
        qp = ops._qparams(torch.tensor(-1.5, device=card),
                          torch.tensor(2.0, device=card), spec)
        qk, mnk, mxk = mm.int8_matmul_fused_cuda(x[0], w[0], zp, alpha, bias,
                                                 qp, spec, block=tile)
        qr, mnr, mxr = mm.int8_matmul_fused_plain(x[0], w[0], zp, alpha,
                                                  bias, qp, spec)
        torch.cuda.synchronize()
        assert torch.equal(qk, qr)
        assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)
    assert ops.tile_launch_counts()[("int8_matmul_fused", run)] == 2


@pytest.mark.parametrize("tile", mm.MATMUL_TILES, ids=_tile_id)
def test_int8_conv_fp_every_tile_matches_plain(card, tile):
    """A MobileNetV2-tiny expand layer (M = 4 x 32 x 32 rows) on every
    tile, bit for bit against the plain version on the CPU."""
    xs, ws = (4, 32, 32, 24), (1, 1, 24, 144)
    g = _gen(card, tile[0])
    x = torch.randint(0, 256, xs, generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, ws, generator=g, device=card,
                      dtype=torch.int8)
    plan = ops.plan_conv(xs, ws, 1, "SAME", 1, 1)
    zp, alpha = torch.tensor(117.0), torch.tensor(2.3e-4)
    ops.reset_launch_counts()
    yk, mnk, mxk = ops.int8_conv_fp(x, w, zp.to(card), alpha.to(card),
                                    plan=plan, block=tile)
    assert ops.tile_launch_counts()[("int8_matmul_fp", tile[0])] == 1
    yr, mnr, mxr = ops.int8_conv_fp(x.cpu(), w.cpu(), zp, alpha, plan=plan)
    assert torch.equal(yk.cpu(), yr)
    assert torch.equal(mnk.cpu(), mnr) and torch.equal(mxk.cpu(), mxr)


def test_int8_matmul_refuses_an_uninstantiated_tile(card):
    x = torch.zeros((1, 4, 32), dtype=torch.uint8, device=card)
    w = torch.zeros((1, 32, 16), dtype=torch.int8, device=card)
    one = torch.tensor(1.0, device=card)
    with pytest.raises(ValueError, match="has no tile"):
        mm.int8_matmul_fp_cuda(x, w, one, one, block=(256, 256, 256))
    with pytest.raises(ValueError, match="has no tile"):
        mm.int8_matmul_fp_cuda(x, w, one, one, block=(48, 128, 128))


def test_conv_site_fp32_products_ignore_global_tf32(card):
    """With TF32 switched on globally, the conv site's backward products
    and its fp path's conv stay full fp32: they match the CPU's within
    1e-5 of the largest element (TF32 would be off by ~1e-3)."""
    from repro_torch.core import backend
    from repro_torch.core.calibration import observation_policy
    from repro_torch.core.policy import QuantPolicy

    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 16, 16, 64), generator=g)
    w = torch.randn((3, 3, 64, 64), generator=g) * 0.05
    r = torch.randn((4, 16, 16, 64), generator=g)
    qx = torch.randint(0, 256, x.shape, generator=g, dtype=torch.uint8)
    qw = torch.randint(-127, 128, w.shape, generator=g, dtype=torch.int8)
    pol = QuantPolicy.w8a8g8(backend="fused")

    def run(dev):
        one = torch.ones((), device=dev)
        xq = x.to(dev).requires_grad_(True)
        wq = w.to(dev).requires_grad_(True)
        y = backend.qconv(pol, xq, backend.QTensor(qx.to(dev), one * 0.02,
                                                   one * 128.0),
                          wq, backend.QTensor(qw.to(dev), one * 1e-3,
                                              one * 0.0))
        dx, dw = torch.autograd.grad(y, [xq, wq], r.to(dev))
        y_fp = backend.qconv(observation_policy(pol), x.to(dev), None,
                             w.to(dev), None)
        return [t.detach().cpu() for t in (y, dx, dw, y_fp)]

    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = True
    try:
        on_card = run(card)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved
    on_cpu = run(torch.device("cpu"))
    assert torch.equal(on_card[0], on_cpu[0])          # alpha * int32
    for a, b in zip(on_card[1:], on_cpu[1:]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


# The enc-dec and VLM families' attention shapes (two kv heads each; the
# model's head counts only repeat them): seamless-m4t-medium's encoder
# bidir and cross core at hd 64 over 1056 frames (a half-padded last kv
# tile of 64), its encoder at 32768 frames, and paligemma-3b's prefix
# core at hd 256, G = 8, over 256 patches; the block is the one
# tuning.attention_block picks.
FRONTEND_CASES = [
    ("bidir", 1056, 1056, 1, 64, 0, 0, None, (64, 64)),
    ("cross", 1024, 1056, 1, 64, 0, 0, None, (64, 64)),
    ("bidir", 32768, 32768, 1, 64, 0, 0, None, (128, 128)),
    ("prefix", 1056, 1056, 8, 256, 0, 256, None, (64, 64)),
]


@pytest.mark.parametrize("case", FRONTEND_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-hd{c[4]}")
def test_attention_kernel_frontend_shapes_match_plain(card, case):
    from repro_torch.kernels import tuning
    assert tuning.attention_block(case[1], case[2], case[4]) == case[8]
    _hold_attention(card, case)


def test_int8_matmul_odd_vocabulary_matches_plain(card):
    """seamless-m4t-medium's head chunk, 1024 rows against its 256206-wide
    vocabulary (N not a multiple of 8: the scalar-store epilogue),
    bit-exact with its statistics."""
    m, k, n = 1024, 1024, 256206
    g = _gen(card, n)
    x = torch.randint(0, 256, (1, m, k), generator=g, device=card,
                      dtype=torch.uint8)
    w = torch.randint(-127, 128, (1, k, n), generator=g, device=card,
                      dtype=torch.int8)
    zp = torch.tensor(117.3, device=card)
    alpha = torch.tensor(2.3e-5, device=card)
    ops.reset_launch_counts()
    yk, mnk, mxk = mm.int8_matmul_fp_cuda(x, w, zp, alpha)
    assert ops.launch_counts()["int8_matmul_fp"] == 1
    yr, mnr, mxr = mm.int8_matmul_fp_plain(x, w, zp, alpha)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)
    assert torch.equal(mnk, mnr) and torch.equal(mxk, mxr)


@pytest.mark.parametrize("block", [None, "64,64"],
                         ids=["tuner", "64x64"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b"])
def test_reduced_frontend_models_on_card_fused_match_simulated(card, arch,
                                                               block,
                                                               monkeypatch):
    """The reduced enc-dec and VLM models on the card: a prefill with
    frames (132 of them: on the tuner's own (256, 128), bq 132 on the
    kernel's tall instantiation; on (64, 64) tiles, a padded last kv tile)
    or patches, then 3 decode
    steps (cross decode reads the cached encoder), fused against
    simulated; the fused prefill launches the attention core once per
    attention layer (the encoder's, the decoder's self and cross; the
    VLM's prefix), decode none; the logits agree within the dense serve
    test's tolerance.  Then one forward + backward within the train
    test's bounds."""
    from repro_torch import configs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    if block:
        monkeypatch.setenv("REPRO_ATTN_BLOCK", block)
    cfg = configs.get_reduced(arch)
    params = model.init_params(cfg, seed=0, device=card)
    g = _gen(card, 5)
    tokens = torch.randint(0, cfg.vocab, (2, 20), generator=g, device=card)
    if cfg.family == "encdec":
        prompt = {"tokens": tokens, "frames": torch.randn(
            (2, 132, cfg.frontend_dim), generator=g, device=card)}
        s, attn_layers = 20, cfg.enc_layers + 2 * cfg.n_layers
    else:
        prompt = {"tokens": tokens, "patches": torch.randn(
            (2, cfg.n_patches, cfg.frontend_dim), generator=g, device=card)}
        s, attn_layers = 20 + cfg.n_patches, cfg.n_layers
    logits = {}
    for backend in ("simulated", "fused"):
        policy = QuantPolicy.w8a8g8(backend=backend)
        quant = model.init_quant_state(cfg, device=card)
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, quant, prompt, cfg, policy,
                                  cache_len=max(s, 132) + 4)
        out = [lg]
        for i in range(3):
            tok = torch.argmax(lg, dim=-1)[:, None]
            lg, cache = model.decode_step(
                params, quant, tok, torch.full((2,), s + i, device=card),
                cache, cfg, policy)
            out.append(lg)
        counts = ops.launch_counts()
        if backend == "fused":
            assert counts["int8_attention"] == attn_layers, counts
            assert all(counts[k] > 0 for k in ("fused_quantize",
                                               "int8_transpose",
                                               "int8_matmul_fp")), counts
        else:
            assert not any(counts.values()), counts
        logits[backend] = torch.stack(out)
    torch.testing.assert_close(logits["fused"], logits["simulated"],
                               rtol=1e-3, atol=1e-3)
    state = steps.init_train_state(cfg, adamw(), seed=0, device=card)
    batch = dict(prompt, tokens=tokens[:, :16], labels=tokens[:, 1:17],
                 mask=torch.ones((2, 16), device=card))
    if cfg.family == "encdec":
        batch["frames"] = prompt["frames"][:, :40]
    res = {}
    for backend in ("simulated", "fused"):
        ops.reset_launch_counts()
        res[backend] = steps.forward_backward(
            cfg, QuantPolicy.w8a8g8(backend=backend), state["params"],
            model.init_quant_state(cfg, device=card), batch, 0, 0)
        counts = ops.launch_counts()
        if backend == "fused":
            assert counts["stochastic_quantize"] > 0, counts
        else:
            assert not any(counts.values()), counts
    (ls, gs, _, _), (lf, gf, _, _) = res["simulated"], res["fused"]
    torch.testing.assert_close(lf, ls, rtol=1e-3, atol=0)
    for name, gr in gs.items():
        if not name.endswith("attn.bk"):      # exact gradient is zero
            assert (gf[name] - gr).norm() <= 5e-2 * gr.norm(), name


def _compress_ranks(rank, world, out_dir, backend):
    """One rank of the card's compressor check: two calls (the step-0
    bootstrap, then the hindsight range) on full-width-like leaves."""
    from repro_torch.runtime import compress
    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(17 + rank)
    grads = {"w": torch.randn((3072, 768), generator=gen, device="cuda")
             * 0.01,
             "b": torch.randn((3072,), generator=gen, device="cuda") * 0.1}
    reduce_fn, update_fn, init_fn = compress.make_compressor()
    state = init_fn(grads)
    ops.reset_launch_counts()
    res = {"grads": {k: v.cpu() for k, v in grads.items()}, "calls": []}
    for seed in (0, 1):
        out, st = reduce_fn(grads, state, seed)
        res["calls"].append(({k: v.cpu() for k, v in out.items()},
                             {k: v.cpu() for k, v in st.items()},
                             {k: v.cpu() for k, v in state.items()}))
        state = update_fn(state, st)
    res["launches"] = ops.launch_counts()["stochastic_quantize"]
    torch.save(res, f"{out_dir}/{backend}{rank}.pt")


@pytest.mark.parametrize("backend, world", [("gloo", 2), ("nccl", 1)])
def test_compressor_on_card_matches_emulation(card, tmp_path, backend,
                                              world):
    """``runtime.compress`` on the card: 2 gloo ranks (gloo reduces CUDA
    tensors; NCCL refuses two ranks on one device), and the 1-rank NCCL
    group a multi-card job's path takes; the quantize on the
    ``stochastic_quantize`` kernel (one launch a leaf a call), each call
    bit for bit the plain one-process emulation on the card."""
    from repro_torch.launch import mesh
    from repro_torch.runtime import compress
    mesh.spawn_ranks(_compress_ranks, world, tmp_path / "store",
                     backend=backend, args=(str(tmp_path), backend))
    ranks = [torch.load(tmp_path / f"{backend}{r}.pt") for r in range(world)]
    grads = [{k: v.to(card) for k, v in r["grads"].items()} for r in ranks]
    for call, seed in enumerate((0, 1)):
        state = {k: v.to(card) for k, v in ranks[0]["calls"][call][2].items()}
        want, wst = compress.emulate_all_reduce_tree(grads, state, seed)
        for r in ranks:
            out, st, _ = r["calls"][call]
            for k in want:
                assert torch.equal(out[k], want[k].cpu()), (call, k)
                assert torch.equal(st[k], wst[k].cpu()), (call, k)
    assert all(r["launches"] == 4 for r in ranks)
