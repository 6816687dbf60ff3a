"""Port vs reference: tile selection (``kernels.tuning``), on the CPU.

The port's ``matmul_block`` keeps the reference's semantics with the CUDA
matmul's own tiles: ``REPRO_MM_BLOCK`` wins before the cache (and must
name a tile the kernel instantiates: the reference's ``256,256,256`` is
refused with the list of tiles, never replaced), the cache is keyed
``(kind, dims, str(dtype))``, ``REPRO_TUNE=benchmark`` times the
candidates through the caller's thunk (a candidate that raises is
skipped; without a thunk the heuristic decides) and the heuristic is the
reference's padding waste with its clamp ``min(b, d)``.  The launch's row
clamp (``int8_matmul.row_tile``) is the counterpart of that clamp.  The
attention tile changes results, so ``attention_block`` equals the
reference's.  The benchmark mode is driven by a scripted clock: each
candidate's run advances it by a set amount, in both packages.
"""
import numpy as np
import pytest
import torch

from repro.kernels import tuning as jtuning
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tuning as ttuning

from test_torch_kernels import SCHED_CASES

MODULES = (jtuning, ttuning)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("REPRO_MM_BLOCK", "REPRO_ATTN_BLOCK", "REPRO_TUNE"):
        monkeypatch.delenv(var, raising=False)
    for mod in MODULES:
        mod.clear_cache()
    yield
    for mod in MODULES:
        mod.clear_cache()


# ---------------------------------------------------------------------------
# The environment.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,fn,raw", [
    ("REPRO_MM_BLOCK", "matmul_block", "128,128"),
    ("REPRO_MM_BLOCK", "matmul_block", "128,0,128"),
    ("REPRO_MM_BLOCK", "matmul_block", "a,b,c"),
    ("REPRO_ATTN_BLOCK", "attention_block", "64"),
    ("REPRO_ATTN_BLOCK", "attention_block", "-64,64"),
    ("REPRO_ATTN_BLOCK", "attention_block", "64,x")])
def test_env_parse_errors_equal_reference(monkeypatch, name, fn, raw):
    monkeypatch.setenv(name, raw)
    msgs = []
    for mod in MODULES:
        with pytest.raises(ValueError) as err:
            getattr(mod, fn)(64, 64, 64)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_env_pins_parse_like_reference(monkeypatch):
    monkeypatch.setenv("REPRO_MM_BLOCK", " 64 128,128 ")
    monkeypatch.setenv("REPRO_ATTN_BLOCK", "8,8")
    for mod in MODULES:
        assert mod.matmul_block(4096, 3072, 3072) == (64, 128, 128)
        assert mod.attention_block(1024, 1024, 128) == (8, 8)


def test_uninstantiated_pin_is_refused(monkeypatch):
    """The reference's default tile is no tile of the CUDA matmul: the pin
    raises with the tiles there are, on the CPU path too."""
    monkeypatch.setenv("REPRO_MM_BLOCK", "256,256,256")
    assert jtuning.matmul_block(8, 8, 8) == (256, 256, 256)
    with pytest.raises(ValueError, match=r"\(128, 128, 128\), \(64, 128, "
                                         r"128\), \(32, 128, 128\), "
                                         r"\(16, 128, 128\)"):
        ttuning.matmul_block(8, 8, 8)
    x = torch.zeros((4, 32), dtype=torch.uint8)
    w = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="REPRO_MM_BLOCK"):
        tops.int8_matmul_fp(x, w, 128.0, 1.0,
                            plan=tops.plan_einsum("mk,kn->mn", 2, 2))
    with pytest.raises(ValueError, match="has no tile"):
        tmm.check_tile((256, 256, 256))
    for tile in ttuning.MATMUL_TILES:
        assert tmm.check_tile(list(tile)) == tile


# ---------------------------------------------------------------------------
# Pin, cache, benchmark.
# ---------------------------------------------------------------------------
def test_pin_wins_before_the_cache(monkeypatch):
    for mod, cached in ((jtuning, (128, 128, 256)),
                        (ttuning, (128, 128, 128))):
        mod._CACHE[("matmul", (4096, 3072, 3072), "int8")] = cached
        assert mod.matmul_block(4096, 3072, 3072) == cached
        monkeypatch.setenv("REPRO_MM_BLOCK", "64,128,128")
        assert mod.matmul_block(4096, 3072, 3072) == (64, 128, 128)
        monkeypatch.delenv("REPRO_MM_BLOCK")
        assert mod.matmul_block(4096, 3072, 3072) == cached
        mod._CACHE[("attention", (64, 64, 16), "int8")] = (8, 8)
        assert mod.attention_block(64, 64, 16) == (8, 8)
        monkeypatch.setenv("REPRO_ATTN_BLOCK", "16,16")
        assert mod.attention_block(64, 64, 16) == (16, 16)
        monkeypatch.delenv("REPRO_ATTN_BLOCK")


def test_cache_key_and_clear_cache():
    for mod in MODULES:
        mod.matmul_block(4, 12288, 3072, dtype="uint8")
        mod.attention_block(200, 200, 128)
        assert set(mod._CACHE) == {("matmul", (4, 12288, 3072), "uint8"),
                                   ("attention", (200, 200, 128), "int8")}
        mod.clear_cache()
        assert mod._CACHE == {}


def test_ops_resolve_the_tile_as_the_reference(monkeypatch):
    """``int8_matmul_fp``, ``int8_conv_fp`` and the fused layer resolve
    ``block=None`` through ``matmul_block`` at the product's (M, N, K),
    with the reference's dtype string; an explicit block is taken as
    given."""
    calls = []
    real = ttuning.matmul_block

    def spy(m, n, k, dtype="int8", bench_thunk=None):
        calls.append((m, n, k, dtype, bench_thunk))
        return real(m, n, k, dtype=dtype)
    monkeypatch.setattr(ttuning, "matmul_block", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 3, 40)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 24)).astype(np.int8))
    tops.int8_matmul_fp(x, w, 128.0, 0.5,
                        plan=tops.plan_einsum("bsk,kn->bsn", 3, 2))
    tops.int8_matmul_fp(x, w, 128.0, 0.5,
                        plan=tops.plan_einsum("bsk,kn->bsn", 3, 2),
                        block=(64, 128, 128))
    xi = torch.from_numpy(rng.integers(0, 256, (2, 6, 6, 8)).astype(
        np.uint8))
    wc = torch.from_numpy(rng.integers(-127, 128, (3, 3, 4, 10)).astype(
        np.int8))
    plan = tops.plan_conv(xi.shape, wc.shape, groups=2)
    tops.int8_conv_fp(xi, wc, 128.0, 0.5, plan=plan)
    tops.int8_matmul_fused(x[0], w, 0.1, 128.0, 0.2, None, -1.0, 1.0)
    assert calls == [(6, 24, 40, "uint8", None),
                     (plan.m, plan.cout_g, plan.k, "uint8", None),
                     (3, 24, 40, "uint8", None)]


def _scripted(mod, monkeypatch, costs: dict, fail=()):
    """A thunk whose run of candidate ``c`` advances a fake clock by
    ``costs[c]`` (raising for those in ``fail``), patched into ``mod``."""
    now = [0.0]
    if mod is ttuning:
        monkeypatch.setattr(ttuning, "_clock", lambda: now[0])
    else:
        class FakeTime:
            @staticmethod
            def perf_counter():
                return now[0]
        monkeypatch.setattr(jtuning, "time", FakeTime)
    runs = []

    def thunk(cand):
        if cand in fail:
            raise RuntimeError(f"tile {cand} refused")

        def run():
            runs.append(cand)
            now[0] += costs[cand]
        return run
    return thunk, runs


@pytest.mark.parametrize("fail_fastest", [False, True])
def test_benchmark_mode_picks_the_fastest(monkeypatch, fail_fastest):
    """Both packages time each candidate once after one warmup run, skip
    one that raises, take the fastest and cache it; no timing without
    ``REPRO_TUNE=benchmark`` or without a thunk."""
    monkeypatch.setenv("REPRO_TUNE", "benchmark")
    for mod in MODULES:
        cands = mod.MATMUL_CANDIDATES
        costs = {c: 3.0 - i for i, c in enumerate(cands)}     # last fastest
        fail = (cands[-1],) if fail_fastest else ()
        thunk, runs = _scripted(mod, monkeypatch, costs, fail)
        got = mod.matmul_block(4096, 4096, 4096, bench_thunk=thunk)
        want = cands[-2] if fail_fastest else cands[-1]
        assert got == want, mod.__name__
        assert runs == [c for c in cands if c not in fail for _ in (0, 1)]
        assert mod._CACHE[("matmul", (4096, 4096, 4096), "int8")] == want
        runs.clear()
        assert mod.matmul_block(4096, 4096, 4096, bench_thunk=thunk) == want
        assert runs == []                                   # cached
        # attention: the same mode over its candidates
        acosts = {c: 1.0 + i for i, c in enumerate(mod.ATTN_CANDIDATES)}
        acosts[(64, 128)] = 0.5
        athunk, _ = _scripted(mod, monkeypatch, acosts)
        assert mod.attention_block(512, 512, 64,
                                   bench_thunk=athunk) == (64, 128)
        # no thunk: the heuristic
        assert mod.matmul_block(4, 12288, 3072) == mod.MATMUL_DEFAULT
    monkeypatch.setenv("REPRO_TUNE", "heuristic")
    for mod in MODULES:
        mod.clear_cache()
        thunk, runs = _scripted(mod, monkeypatch,
                                {c: 1.0 for c in mod.MATMUL_CANDIDATES})
        assert mod.matmul_block(4096, 4096, 4096, bench_thunk=thunk) == \
            mod.MATMUL_DEFAULT
        assert runs == []


def test_benchmark_fence_is_a_no_op_without_cuda():
    """The fence synchronizes the device only once CUDA is in use."""
    assert not torch.cuda.is_initialized()
    ttuning._fence()


# ---------------------------------------------------------------------------
# The heuristic and the row clamp.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dims", [(1, 12288, 3072), (4, 1408, 2048),
                                  (552, 1408, 2048), (4096, 3072, 3072),
                                  (17, 100, 7), (40, 256206, 1024)])
def test_padding_waste_equals_reference(dims):
    for block in ttuning.MATMUL_TILES + jtuning.MATMUL_CANDIDATES:
        assert ttuning._padding_waste(dims, block) == \
            jtuning._padding_waste(dims, block)


@pytest.mark.parametrize("m,chosen,runs", [
    (1, 128, 16), (4, 128, 16), (16, 128, 16), (17, 128, 32),
    (40, 128, 64), (128, 128, 128), (552, 64, 64), (4096, 128, 128)])
def test_row_clamp(m, chosen, runs):
    """The heuristic keeps the default at decode (the clamp makes every
    candidate's padding equal there) and takes 64 rows at the MoE
    prefill's M = 552; the launch then runs the least row tile covering
    M."""
    n, k = (1408, 2048) if m in (4, 552) else (12288, 3072)
    block = ttuning.matmul_block(m, n, k)
    assert block == (chosen, 128, 128)
    assert tmm.row_tile(block[0], m) == runs
    assert runs in tmm.ROW_TILES


def test_row_tile_is_the_least_covering_tile():
    for bm in tmm.ROW_TILES:
        for m in range(1, 300):
            t = tmm.row_tile(bm, m)
            if m >= bm:
                assert t == bm
                continue
            assert m <= t <= bm and t in tmm.ROW_TILES
            assert not [r for r in tmm.ROW_TILES if m <= r < t]


@pytest.mark.parametrize("sq,skv,hd", SCHED_CASES + [
    (200, 200, 128), (132, 132, 256), (1056, 1056, 64), (1024, 1056, 64),
    (8192, 8192, 256), (4, 4, 16)])
def test_attention_block_equals_reference(sq, skv, hd):
    assert ttuning.attention_block(sq, skv, hd) == \
        tuple(jtuning.attention_block(sq, skv, hd))
    assert ttuning.ATTN_CANDIDATES == jtuning.ATTN_CANDIDATES
