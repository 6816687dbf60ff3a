"""Port vs reference: the training slice (stochastic gradient quantizer,
STE, gradient barrier, attention-core backward, optimizers, the train
step) against the JAX package on the CPU.

The reference is the JAX ``simulated`` backend (its fused full step is
not bit-stable on the installed jax; see ROADMAP §3) and, for the kernel,
the Pallas kernel in interpret mode and ``ref.ref_stochastic_quantize``.
Both sides take the same inputs from numpy; the port's stochastic-rounding
noise provider (``backend.site_noise``, keyed by site seed and shape) is
patched to return the reference's ``jax.random.uniform(site_key(seed, 1),
shape)``, so both quantize every gradient with the same noise.

Tolerances, stated per test:
  * integer images, min/max statistics, the barrier's quantized cotangent
    and statistics vector: bit-equal;
  * the attention-core backward (fp32 products, other summation order):
    rtol 1e-4;
  * optimizers: rtol 1e-6 (the same fp32 ops; ``global_norm`` sums in
    another order);
  * full steps: see ``_check_step``.  The port's two backends agree bit
    for bit on the CPU; against JAX, XLA's and PyTorch's ``exp``/``tanh``
    and summation orders differ by ulps, and such differences flip a
    requantized attention probability or a stochastically rounded gradient
    by one level, which the next layers carry on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro.core import backend as jbackend
from repro.core import qlinear as jqlinear
from repro.core import quant as jquant
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import int8_attention as jattn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import schedules as jsched
from repro.optim import sgdm as jsgdm
from repro.runtime import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.core import backend as tbackend
from repro_torch.core import qlinear as tqlinear
from repro_torch.core import quant as tquant
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import int8_attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.runtime import steps as tsteps

GSPEC_J = jquant.QuantSpec(bits=8, symmetric=False, stochastic=True)
GSPEC_T = tquant.QuantSpec(bits=8, symmetric=False, stochastic=True)


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                  err_msg=what)


def _jax_noise(seed, shape, device):
    key = jbackend.site_key(jnp.asarray(seed, jnp.int32), 1)
    u = jax.random.uniform(key, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tbackend, "site_noise", _jax_noise)


# ---------------------------------------------------------------------------
# (a) the stochastic quantizer: bit-exact images and min/max.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 70), (257, 300),
                                   (3, 5, 17)])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stochastic_quantize_plain_matches_jax(shape, sym, dtype):
    rng = np.random.default_rng(sum(shape) + sym)
    x = (rng.standard_normal(shape) * 2.5).astype(np.float32)
    if dtype == "bfloat16":          # the canonical fp32 view of a bf16 grad
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    u = rng.random(shape, dtype=np.float32)
    lo, hi = np.float32(-2.0), np.float32(3.0)        # clips both tails
    sj = dataclasses.replace(GSPEC_J, symmetric=sym)
    st = dataclasses.replace(GSPEC_T, symmetric=sym)
    qj, mnj, mxj = jops.stochastic_quantize(jnp.asarray(x), lo, hi,
                                            jnp.asarray(u), spec=sj)
    qr, mnr, mxr = jref.ref_stochastic_quantize(jnp.asarray(x), lo, hi,
                                                jnp.asarray(u), sj)
    qt, mnt, mxt = tops.stochastic_quantize(
        torch.from_numpy(x), torch.tensor(lo), torch.tensor(hi),
        torch.from_numpy(u), spec=st)
    assert qt.dtype == (torch.int8 if sym else torch.uint8)
    for ref in ((qj, mnj, mxj), (qr, mnr, mxr)):
        _eq(ref[0], qt, "q")
        _eq(ref[1], mnt, "min")
        _eq(ref[2], mxt, "max")


def test_stochastic_quantize_on_chip_form_rejects_cpu():
    """The on-chip Philox form exists only in the CUDA kernel, as the
    reference's on-chip form exists only on a TPU."""
    with pytest.raises(ValueError, match="CPU tensor"):
        tops.stochastic_quantize(torch.zeros(8), 0.0, 1.0, None,
                                 spec=GSPEC_T, on_chip_prng=True, seed=3)
    with pytest.raises(ValueError, match="noise"):
        tops.stochastic_quantize(torch.zeros(8), 0.0, 1.0, None, spec=GSPEC_T)


def test_site_seed_matches_site_key_mixing():
    for seed in (0, 1, 7_000_000, 262144 + 8192 * 3 + 64 * 5 + 2):
        j = np.uint32(seed) ^ np.uint32(0x9E3779B9)
        assert tbackend.site_seed(seed, 1) == int(j)


# ---------------------------------------------------------------------------
# (b) the clipped STE and the gradient barrier.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sym", [False, True])
def test_fake_quant_ste_matches_jax(sym):
    """Values bit-equal; the gradient passes exactly where the reference's
    mask does (range [-1.5, 2] clips both tails)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 40)) * 2).astype(np.float32)
    g = rng.standard_normal((6, 40)).astype(np.float32)
    sj = jquant.QuantSpec(bits=8, symmetric=sym)
    st = tquant.QuantSpec(bits=8, symmetric=sym)
    yj, vjp = jax.vjp(lambda v: jquant.fake_quant_ste(v, -1.5, 2.0, sj),
                      jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tquant.fake_quant_ste(xt, -1.5, 2.0, st)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    _eq(yj, yt, "values")
    _eq(vjp(jnp.asarray(g))[0], gt, "ste gradient")


@pytest.mark.parametrize("backend", ["simulated", "fused"])
@pytest.mark.parametrize("leaf", [[0.0, 0.0, 0.0], [-0.4, 0.3, 1.0]],
                         ids=["uninit", "init"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_barrier_matches_jax_vjp(backend, leaf, dtype, jax_noise):
    """Identity forward; backward: the quantized cotangent bit-equal to
    ``jax.vjp`` of the reference barrier, and the statistics vector
    delivered as the leaf's gradient (the cotangent channel)."""
    rng = np.random.default_rng(11)
    y = rng.standard_normal((4, 9, 24)).astype(np.float32)
    g = (rng.standard_normal((4, 9, 24)) * 0.3).astype(np.float32)
    leaf = np.asarray(leaf, np.float32)
    seed, step = 8192 * 2 + 64 * 3 + 1, 1
    jdt = jnp.dtype(dtype)
    pj = JPolicy.w8a8g8(backend="simulated")
    yo, vjp = jax.vjp(
        lambda a, lf: jqlinear.grad_quant_barrier(
            a, lf, pj, jnp.int32(seed), jnp.int32(step)),
        jnp.asarray(y, jdt), jnp.asarray(leaf))
    gq_j, st_j = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dtype)
    pt = TPolicy.w8a8g8(backend=backend)
    yt = torch.from_numpy(y).to(tdt).requires_grad_(True)
    lt = torch.from_numpy(leaf).requires_grad_(True)
    out = tqlinear.grad_quant_barrier(yt, lt, pt, seed, step)
    _eq(yo.astype(jnp.float32), out.float(), "forward is the identity")
    gq_t, st_t = torch.autograd.grad(out, [yt, lt],
                                     torch.from_numpy(g).to(tdt))
    assert gq_t.dtype == tdt
    _eq(gq_j.astype(jnp.float32), gq_t.float(), "quantized cotangent")
    _eq(st_j, st_t, "stats vector")


# ---------------------------------------------------------------------------
# (c) the attention-core backward.
# ---------------------------------------------------------------------------
BWD_CASES = [
    # mode, sq, groups, hd, window, (bq, bkv), kv_len
    ("causal", 24, 3, 8, 0, (8, 8), None),
    ("sliding", 29, 2, 16, 9, (16, 8), None),      # ragged sq: padded rows
    ("causal", 19, 4, 12, 0, (8, 16), 15),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_attention_core_backward_matches_jax(case):
    """fp32 cotangents of q/k/v: the same block walk and the same exact
    QK^T recompute; the fp32 products sum in another order (rtol 1e-4)."""
    mode, sq, groups, hd, window, (bq, bkv), kv_len = case
    rng = np.random.default_rng(sq + hd)
    zb = 2
    q = rng.integers(0, 256, (zb * groups, sq, hd), dtype=np.uint8)
    k = rng.integers(-127, 128, (zb, sq, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (zb, sq, hd), dtype=np.int8)
    s_q, s_k, s_v = 0.021, 0.013, 0.017
    scale_p = np.float32(1.0) / np.float32(255.0)
    regs = np.array([[131.0, hd ** -0.5 * s_q * s_k, scale_p, 0.0,
                      scale_p * s_v, 0.0, 1.0, 0.0]], np.float32)
    kvl = np.array([[sq if kv_len is None else kv_len]], np.int32)
    qh = ((q.astype(np.float32) - 131.0) * s_q).astype(np.float32)
    kh = (k.astype(np.float32) * s_k).astype(np.float32)
    vh = (v.astype(np.float32) * s_v).astype(np.float32)
    kw = dict(sq=sq, skv=sq, hd=hd, bq=bq, bkv=bkv, groups=groups, mode=mode,
              window=window, sm_scale=hd ** -0.5)
    sj, st = jattn.make_schedule(**kw), tattn.make_schedule(**kw)
    out, ml, _ = jattn.attention_core_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(regs),
        jnp.asarray(kvl), sched=sj)
    out, ml = np.asarray(out), np.asarray(ml)
    g = rng.standard_normal(out.shape).astype(np.float32)
    args = (qh, kh, vh, q, k, v, regs, kvl, out, ml, g)
    dj = jattn.attention_core_backward(*map(jnp.asarray, args), sched=sj)
    dt = tattn.attention_core_backward(*map(torch.from_numpy, args), sched=st)
    for name, a, b in zip("qkv", dj, dt):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")



def _block_walk_backward(qh, kh, vh, q_u8, k_i8, regs, kvlen, out, ml,
                         g_out, sched):
    """The backward as the reference's scan writes it, one ``(bq, bkv)``
    block pair at a time (q blocks outer): the oracle of the port's
    chunked form."""
    S = sched
    bh = q_u8.shape[0]
    zb = bh // S.groups
    f32, f64 = torch.float32, torch.float64
    sqp, skp = S.nq * S.bq, S.nkv * S.bkv

    def qsplit(x, d):
        return tattn._pad_axis(x, sqp, 1).reshape(zb, S.groups, S.nq, S.bq,
                                                  d)

    def ksplit(x, d):
        return tattn._pad_axis(x, skp, 1).reshape(zb, S.nkv, S.bkv, d)
    gf = g_out.to(f32)
    d_row = torch.einsum("bsh,bsh->bs", gf, out)
    qz, qhz, gz = qsplit(q_u8, S.hd), qsplit(qh, S.hd), qsplit(gf, S.hd)
    mz, lz = qsplit(ml[..., 0:1], 1)[..., 0], qsplit(ml[..., 1:2], 1)[..., 0]
    dz = qsplit(d_row[..., None], 1)[..., 0]
    kz, khz, vhz = ksplit(k_i8, S.hd), ksplit(kh, S.hd), ksplit(vh, S.hd)
    zp_q, alpha = regs.reshape(-1)[0], regs.reshape(-1)[1]
    rows = torch.arange(S.bq)[:, None]
    cols = torch.arange(S.bkv)[None, :]
    dk = torch.zeros((zb, S.nkv, S.bkv, S.hd))
    dv = torch.zeros_like(dk)
    dqs = []
    for i in range(S.nq):
        rq = (qz[:, :, i].to(torch.int32) - zp_q.to(torch.int32)).to(f64)
        dq_i = torch.zeros((zb, S.groups, S.bq, S.hd))
        for j in range(S.nkv):
            s = alpha * torch.einsum("zgqh,zkh->zgqk", rq,
                                     kz[:, j].to(f64)).to(f32)
            q_pos = i * S.bq + rows
            mask = tattn._element_mask(q_pos, j * S.bkv + cols,
                                       kvlen.reshape(()), S) & (q_pos < S.sq)
            p = torch.where(mask, torch.exp(s - mz[:, :, i][..., None]), 0.0)
            r = p / lz[:, :, i][..., None].clamp(min=1e-30)
            d_ov = torch.einsum("zgqh,zkh->zgqk", gz[:, :, i], vhz[:, j])
            ds = (r * (d_ov - dz[:, :, i][..., None])) * S.sm_scale
            dq_i = dq_i + torch.einsum("zgqk,zkh->zgqh", ds, khz[:, j])
            dk[:, j] += torch.einsum("zgqk,zgqh->zkh", ds, qhz[:, :, i])
            dv[:, j] += torch.einsum("zgqk,zgqh->zkh", r, gz[:, :, i])
        dqs.append(dq_i)
    dq = torch.stack(dqs).permute(1, 2, 0, 3, 4).reshape(bh, sqp, S.hd)
    return (dq[:, :S.sq], dk.reshape(zb, skp, S.hd)[:, :S.skv],
            dv.reshape(zb, skp, S.hd)[:, :S.skv])


@pytest.mark.parametrize("case", [
    ("causal", 24, 24, 3, 8, 0, 0, None, (8, 8)),
    ("sliding", 29, 29, 2, 16, 9, 0, None, (16, 8)),
    ("prefix", 132, 132, 4, 16, 0, 100, None, (64, 64)),
    ("cross", 33, 70, 2, 12, 0, 0, 61, (16, 32)),
    ("bidir", 132, 132, 1, 16, 0, 0, None, (64, 64))],
    ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_attention_core_backward_is_the_block_walk(case):
    """The backward computes the block pairs of a chunk of q blocks at
    once and sums them in the reference's order: bit for bit the pair by
    pair walk of the reference's scan, masked pairs, padded rows and
    tiles included."""
    mode, sq, skv, groups, hd, window, prefix, kv_len, (bq, bkv) = case
    rng = np.random.default_rng(sq + skv + hd)
    zb = 2
    q = torch.from_numpy(rng.integers(0, 256, (zb * groups, sq, hd),
                                      dtype=np.uint8))
    k = torch.from_numpy(rng.integers(-127, 128, (zb, skv, hd),
                                      dtype=np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (zb, skv, hd),
                                      dtype=np.int8))
    sp = 1.0 / 255.0
    regs = torch.tensor([131.0, hd ** -0.5 * 0.021 * 0.013, sp, 0.0,
                         sp * 0.017, 0.0, 1.0, 0.0])
    kvl = torch.tensor([skv if kv_len is None else kv_len],
                       dtype=torch.int32)
    qh, kh, vh = (q.float() - 131.0) * 0.021, k.float() * 0.013, \
        v.float() * 0.017
    sched = tattn.make_schedule(sq=sq, skv=skv, hd=hd, bq=bq, bkv=bkv,
                                groups=groups, mode=mode, window=window,
                                prefix_len=prefix, sm_scale=hd ** -0.5)
    out, ml, _ = tattn.attention_core_reference(q, k, v, regs, kvl,
                                                sched=sched)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = tattn.attention_core_backward(qh, kh, vh, q, k, v, regs, kvl, out,
                                        ml, g, sched=sched)
    want = _block_walk_backward(qh, kh, vh, q, k, regs, kvl, out, ml, g,
                                sched)
    for name, a, b in zip("qkv", want, got):
        assert torch.equal(a, b), f"d{name}"

# ---------------------------------------------------------------------------
# (d) optimizers and schedules.
# ---------------------------------------------------------------------------
def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(4)]


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.1)), ("adamw", dict(weight_decay=0.0)),
    ("sgdm", dict(momentum=0.9, weight_decay=1e-4)),
    ("sgdm", dict(momentum=0.9, nesterov=True))])
def test_optimizer_matches_jax(name, kw):
    """Three updates from random gradients (rtol 1e-6: the same fp32 ops;
    pow in the bias correction may differ by an ulp)."""
    params, *grads = _trees(len(kw) + len(name))
    oj = {"adamw": jadamw, "sgdm": jsgdm}[name](**kw)
    ot = {"adamw": topt.adamw, "sgdm": topt.sgdm}[name](**kw)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = oj.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = ot.init(pt)
    for i, g in enumerate(grads[:3]):
        lr = 1e-2 / (i + 1)
        upd, sj = oj.update({k: jnp.asarray(v) for k, v in g.items()}, sj,
                            pj, jnp.float32(lr))
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, upd)
        st = ot.update({k: torch.from_numpy(v) for k, v in g.items()}, st,
                       pt, lr)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for m in ("m", "v") if name == "adamw" else ("m",):
            np.testing.assert_allclose(st[m][k].numpy(),
                                       np.asarray(sj[m][k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{m}/{k}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_apply_updates_match_jax(max_norm):
    g, u, p = _trees(5)[:3]
    cj, nj = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    ct, nt = topt.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    pt = topt.apply_updates({k: torch.from_numpy(v.copy())
                             for k, v in p.items()},
                            {k: torch.from_numpy(v) for k, v in u.items()})
    for k in g:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   rtol=1e-6, err_msg=k)
        _eq(p[k] + u[k], pt[k], k)


def test_schedules_match_jax():
    cj, ct = jsched.cosine(3e-3, 50, warmup=5, final_lr=1e-5), \
        topt.cosine(3e-3, 50, warmup=5, final_lr=1e-5)
    dj, dt = jsched.step_decay(0.1, (3, 7)), topt.step_decay(0.1, (3, 7))
    for s in (0, 1, 4, 5, 6, 17, 49, 50, 60):
        # atol: near the end cos(pi t) ~ -1 cancels, and an ulp of cos
        # is ~1e-10 there (3e-8 of the peak rate).
        np.testing.assert_allclose(ct(s), float(cj(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-9, err_msg=f"cosine {s}")
        assert dt(s) == float(dj(jnp.int32(s))), s
    assert topt.constant(3e-3)(7) == float(jsched.constant(3e-3)(7))


# ---------------------------------------------------------------------------
# (e, f) full train steps of the tests/test_backend.py::_setup config.
# ---------------------------------------------------------------------------
ARCH, LR, SEQ, BATCH = "starcoder2-3b", 3e-3, 32, 4


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if np.asarray(v).dtype.kind in "iu" else torch.float32)
        for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_init():
    """The reference's initial train state and first two batches (numpy),
    shared by the step tests (compute_dtype does not change the init)."""
    cfg = jconfigs.get_reduced(ARCH)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), cfg,
                                    jadamw(weight_decay=0.0),
                                    JPolicy.w8a8g8(backend="simulated"))
    stream = jdata.for_arch(cfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return _np(state), [_np(stream.batch(i)) for i in range(2)]


def _cfgs(compute_dtype):
    return (dataclasses.replace(jconfigs.get_reduced(ARCH),
                                compute_dtype=compute_dtype),
            dataclasses.replace(tconfigs.get_reduced(ARCH),
                                compute_dtype=compute_dtype))


def _run_pair(jax_init, steps, grad_accum):
    """JAX simulated vs the port's two backends from the same init state,
    batches and noise (bf16 compute, the _setup config).  Returns per-step
    (loss, quant tree, params tree) lists in the JAX layout."""
    init, batches = jax_init
    cfg_j, cfg_t = _cfgs("bfloat16")
    policy = JPolicy.w8a8g8(backend="simulated")
    opt = jadamw(weight_decay=0.0)
    ts = jax.jit(jsteps.make_train_step(cfg_j, policy, opt,
                                        jsched.constant(LR),
                                        grad_accum=grad_accum))
    state = jax.tree_util.tree_map(jnp.asarray, init)
    ref = []
    for i in range(steps):
        state, met = ts(state, batches[i])
        s = _np(state)
        ref.append((float(met["loss"]), s["quant"], s["params"]))
    port = {}
    for bk in ("simulated", "fused"):
        o = topt.adamw(weight_decay=0.0)
        st = convert.train_state_from_jax(init, cfg_t, o, "cpu")
        step = tsteps.make_train_step(cfg_t, TPolicy.w8a8g8(backend=bk), o,
                                      topt.constant(LR),
                                      grad_accum=grad_accum)
        port[bk] = []
        for i in range(steps):
            st, met = step(st, _torch_batch(batches[i]))
            port[bk].append((float(met["loss"]),
                             convert.to_jax_layout(st["quant"], cfg_t),
                             convert.params_to_jax(st["params"], cfg_t)))
    return ref, port


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _check_step(ref, got, what):
    """Tolerances (bf16 compute, the _setup config).
      * loss: relative 3e-3 (step 0 is forward only: observed 3e-4; step 1
        also carries the first update);
      * quant state: the visited/initialized flags exactly; activation
        ranges within 2e-2 relative (one bf16 rounding flip of an
        activation moves an 8-bit level); gradient ranges within 1e-1
        relative (a one-level flip at each stochastic rounding upstream
        moves the next site's extreme values; observed up to 4e-2 at the
        first layer);
      * params: AdamW's first steps are sign-like (|update| ~ lr whatever
        |g|), so a gradient element near 0 whose sign differs moves its
        parameter by 2 lr.  Held: at most 5% of each tensor's elements
        differ by more than lr/2 from the reference after the step, and
        none by more than 2 lr per step.  ``attn/bk`` is left out of the
        fraction: its exact gradient is zero (softmax is invariant to a
        key bias), so its update is the sign of rounding noise.
    """
    loss_r, quant_r, params_r = ref
    loss_t, quant_t, params_t = got
    assert abs(loss_t - loss_r) <= 3e-3 * abs(loss_r), (what, loss_t, loss_r)
    lq_r, lq_t = _leaves(quant_r), _leaves(quant_t)
    assert [p for p, _ in lq_r] == [p for p, _ in lq_t]
    for (path, a), (_, b) in zip(lq_r, lq_t):
        name = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a[..., 2], b[..., 2], err_msg=name)
        tol = 1e-1 if "'grad'" in name else 2e-2
        np.testing.assert_allclose(b, a, rtol=tol, atol=1e-6,
                                   err_msg=f"{what} {name}")
    lp_r, lp_t = _leaves(params_r), _leaves(params_t)
    assert [p for p, _ in lp_r] == [p for p, _ in lp_t]
    n_steps = what[1] + 1
    for (path, a), (_, b) in zip(lp_r, lp_t):
        name = jax.tree_util.keystr(path)
        d = np.abs(a - b)
        assert d.max() <= 2 * LR * n_steps * 1.001, (what, name, d.max())
        if "'bk'" not in name:
            frac = float(np.mean(d > LR / 2))
            assert frac <= 0.05, (what, name, frac)


@pytest.fixture(scope="module")
def two_steps(jax_init):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbackend, "site_noise", _jax_noise)
        return _run_pair(jax_init, steps=2, grad_accum=1)


def test_two_train_steps_match_jax_simulated(two_steps):
    ref, port = two_steps
    for bk, got in port.items():
        for i in range(2):
            _check_step(ref[i], got[i], (bk, i))


def test_port_backends_agree_bitwise_on_train_steps(two_steps):
    """On the CPU the fused backend runs the kernels' plain versions with
    the same noise: losses, quant trees and params are bit-identical."""
    _, port = two_steps
    for (ls, qs, ps), (lf, qf, pf) in zip(port["simulated"], port["fused"]):
        assert ls == lf
        for (path, a), (_, b) in zip(_leaves(qs) + _leaves(ps),
                                     _leaves(qf) + _leaves(pf)):
            np.testing.assert_array_equal(a, b,
                                          err_msg=jax.tree_util.keystr(path))


def test_every_site_initialized_after_first_step(two_steps):
    """One estimator update per step: after step 0 every visited leaf is
    initialized (activation, attention-core and gradient sites)."""
    ref, port = two_steps
    for _, quant, _ in [ref[0]] + [p[0] for p in port.values()]:
        flags = {jax.tree_util.keystr(p): np.asarray(v)[..., 2]
                 for p, v in _leaves(quant)}
        unvisited = [n for n, f in flags.items() if not np.all(f == 1.0)]
        # k/v act leaves are never visited: q/k/v share one input site.
        assert all("['k']['act']" in n or "['v']['act']" in n
                   for n in unvisited), unvisited


def test_grad_accum_two_matches_jax(jax_init, jax_noise):
    """One step with two microbatches: statistics combine by min/max,
    gradients average (same tolerances as the two-step test)."""
    ref, port = _run_pair(jax_init, steps=1, grad_accum=2)
    for bk, got in port.items():
        _check_step(ref[0], got[0], (bk, 0))


def test_first_step_gradients_match_jax_fp32(jax_init, jax_noise):
    """The parameter gradients of one forward + backward in fp32 compute
    (the statistics channel included) against ``jax.value_and_grad`` of
    the reference ``loss_fn``.  The head and final norm come first in the
    backward pass and agree to 1e-6; each layer further down inherits the
    one-level flips of the stochastic roundings above it (observed up to
    2.3e-2 relative L2 at the first layer), so layers are held to 5e-2.
    ``attn/bk`` has an exactly-zero true gradient and is held to an
    absolute bound instead."""
    init, batches = jax_init
    cfg_j, cfg_t = _cfgs("float32")
    policy = JPolicy.w8a8g8(backend="simulated")
    state = jax.tree_util.tree_map(jnp.asarray, init)
    batch = batches[0]
    (loss_j, (fwd_j, _)), (pg_j, qg_j) = jax.jit(jax.value_and_grad(
        lambda p, q: jmodel.loss_fn(p, q, batch, cfg_j, policy, jnp.int32(0),
                                    jnp.int32(0)),
        argnums=(0, 1), has_aux=True))(state["params"], state["quant"])
    st = convert.train_state_from_jax(init, cfg_t, topt.adamw(), "cpu")
    loss_t, grads, stats, _ = tsteps.forward_backward(
        cfg_t, TPolicy.w8a8g8(), st["params"], st["quant"],
        _torch_batch(batch), 0, 0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    # The statistics tree: merge_stats of the forward tree and the
    # cotangent channel, leaf by leaf (flags exact; ranges as above).
    stats_j = _np(jqlinear.merge_stats(fwd_j, qg_j))
    for (path, a), (_, b) in zip(_leaves(stats_j),
                                 _leaves(convert.to_jax_layout(stats,
                                                               cfg_t))):
        name = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a[..., 2], b[..., 2], err_msg=name)
        np.testing.assert_allclose(b, a, rtol=5e-2 if "'grad'" in name
                                   else 1e-5, atol=1e-7, err_msg=name)
    got = convert.params_to_jax(st["params"], cfg_t, grads)
    for (path, a), (_, b) in zip(_leaves(_np(pg_j)), _leaves(got)):
        name = jax.tree_util.keystr(path)
        err = np.linalg.norm(b - a)
        if "'bk'" in name:
            assert err <= 0.05 * np.linalg.norm(a) + 1e-3, name
            continue
        tol = 1e-6 if ("head" in name or "final_norm" in name) else 5e-2
        assert err <= tol * np.linalg.norm(a), (name,
                                                err / np.linalg.norm(a))


# ---------------------------------------------------------------------------
# (g) the command-line entry point.
# ---------------------------------------------------------------------------
def test_train_main_runs_on_cpu():
    run = ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "4", "--seq", "32"])
    assert len(run.losses) == 2 and np.all(np.isfinite(run.losses))
    assert run.state["step"] == 2
    assert all(ms > 0 for ms in run.step_ms)


def test_train_main_rejects_dynamic_estimator_on_fused():
    with pytest.raises(ValueError, match="fully-static"):
        ttrain.main(["--reduced", "--device", "cpu", "--steps", "1",
                     "--policy", "current"])
