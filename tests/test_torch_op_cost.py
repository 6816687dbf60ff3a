"""``launch.op_cost.CostMode`` (the dispatched-op counterpart of the
reference's HLO cost analyzer) against ``repro.launch.hlo_cost.analyze``
on the same functions, jitted: FLOPs of a product, of a ten-iteration
loop (an eager loop against ``lax.scan``, with its transcendentals) and
of a convolution equal; the bytes of ``sum(x * 2)`` at least one read
and under 8x; collectives under a fake process group counted by the
reference's kind names, as ``tests/test_hlo_cost.py`` counts them in
HLO text."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.op_cost import COLLECTIVE_KINDS, CostMode, analyze


def _ref(fn, *args) -> dict:
    import jax

    from repro.launch import hlo_cost
    compiled = jax.jit(fn).lower(*args).compile()
    return hlo_cost.analyze(compiled.as_text())


def test_kinds_are_the_references():
    from repro.launch import hlo_cost
    assert COLLECTIVE_KINDS == hlo_cost.COLLECTIVE_KINDS


def test_product_flops_equal():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 128)), rng.standard_normal((128, 32))
    ours = analyze(torch.matmul, torch.tensor(a, dtype=torch.float32),
                   torch.tensor(b, dtype=torch.float32))
    theirs = _ref(lambda x, y: x @ y, jnp.asarray(a, jnp.float32),
                  jnp.asarray(b, jnp.float32))
    assert ours["flops"] == theirs["flops"] == 2 * 64 * 128 * 32


def test_loop_flops_and_transcendentals_equal():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    x, w = rng.standard_normal((32, 32)), rng.standard_normal((32, 32))

    def eager(c, w):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    def scanned(c, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, c, None, length=10)[0]

    ours = analyze(eager, torch.tensor(x, dtype=torch.float32),
                   torch.tensor(w, dtype=torch.float32))
    theirs = _ref(scanned, jnp.asarray(x, jnp.float32),
                  jnp.asarray(w, jnp.float32))
    assert ours["flops"] == theirs["flops"] == 10 * 2 * 32 ** 3
    assert ours["transcendentals"] == theirs["transcendentals"] == \
        10 * 32 * 32


def test_conv_flops_equal():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)     # NHWC
    w = rng.standard_normal((3, 3, 8, 12)).astype(np.float32)      # HWIO

    def ref(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    xt = torch.tensor(x).permute(0, 3, 1, 2)                       # NCHW
    wt = torch.tensor(w).permute(3, 2, 0, 1)             # [Cout, Cin, kh, kw]
    ours = analyze(lambda a, b: torch.nn.functional.conv2d(a, b, padding=1),
                   xt, wt)
    theirs = _ref(ref, jnp.asarray(x), jnp.asarray(w))
    assert ours["flops"] == theirs["flops"] == 2 * (2 * 16 * 16 * 12) * 72


def test_bytes_nonzero_and_plausible():
    x = torch.zeros(1024, 1024)
    ours = analyze(lambda t: torch.sum(t * 2.0), x)
    nbytes = 1024 * 1024 * 4
    assert nbytes <= ours["bytes_accessed"] < 8 * nbytes
    assert ours["flops"] == 0 and ours["collective_ops"] == 0


def test_view_and_slice_window():
    """Views count nothing; a copy into a slice counts its window (read
    and written), not the buffer."""
    buf, upd = torch.zeros(64, 1024), torch.ones(1, 1024)
    ours = analyze(lambda b, u: b[3:4].copy_(u), buf, upd)
    assert ours["bytes_accessed"] == 2 * upd.numel() * 4
    assert analyze(lambda b: b[2:5].reshape(-1, 2).t()[1], buf)[
        "bytes_accessed"] == 0
    # a reshape that must copy is a materialising op
    assert analyze(lambda b: b.t()[2:5].reshape(-1), buf)[
        "bytes_accessed"] == 2 * 3 * 64 * 4


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_by_kind(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.ones(16, 8)
        big = torch.empty(64, 8)
        small = torch.empty(4, 8)
        with CostMode() as mode:
            dist.all_reduce(x)
            dist.all_gather_into_tensor(big, x)
            dist.reduce_scatter_tensor(small, x)
    out = mode.result()
    c = out["collectives"]
    assert c["all-reduce"] == {"ops": 1, "operand_bytes": 16 * 8 * 4,
                               "result_bytes": 16 * 8 * 4}
    assert c["all-gather"] == {"ops": 1, "operand_bytes": 512,
                               "result_bytes": 4 * 512}
    assert c["reduce-scatter"] == {"ops": 1, "operand_bytes": 512,
                                   "result_bytes": 128}
    assert out["collective_ops"] == 3
    assert out["collective_operand_bytes"] == 3 * 512
    assert set(c) == set(COLLECTIVE_KINDS)


def test_live_storage_peak():
    """Each new storage counts once while it lives; ``hold`` registers
    the arguments."""
    x = torch.zeros(256)
    with CostMode() as mode:
        assert mode.hold({"x": x, "again": [x, x[1:]]}) == 1024
        y = x * 2
        z = y + 1
        del y
        w = z[2:]
        assert mode.live_bytes == 2048
    assert mode.peak_bytes == 3072
    del z, w
