"""Port vs reference: the int8 in-hindsight gradient all-reduce
(``repro_torch.runtime.compress``) against ``repro.runtime.compress`` on the
CPU, 4 ranks a side.

The reference runs in a subprocess with 4 forced host devices
(``shard_map`` over a ``data`` mesh, stacked per-replica gradients); the
port runs 4 gloo ranks (``launch.mesh.spawn_ranks``, a FileStore under
``tmp_path``), each with its own replica's gradients.  Fed the reference's
noise (the rank processes patch ``compress.leaf_noise`` with the
``fold_in(fold_in(PRNGKey(seed), leaf), rank)`` draws the subprocess saved),
the reduced means, the statistics and the range update agree bit for bit
on a first call (step-0 bootstrap: the pmax of |g|) and a second (the
hindsight range).  Then, on the port's own noise, the mean over 30 seeds
lies within 5% of the fp32 mean (the reference test's bar).

This module imports no JAX at its top: the rank processes import it.
"""
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.launch import mesh
from repro_torch.runtime import compress

WORLD, SEEDS, R = 4, (0, 1), 30

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.runtime import compress
    out = sys.argv[1]
    mesh = jax.make_mesh((4,), ("data",))
    reduce_fn, update_fn, init_fn = compress.make_compressor(mesh, ("data",))
    reduce_jit = jax.jit(reduce_fn)
    rng = np.random.default_rng(0)
    grads = {"a": (rng.standard_normal((4, 64, 32)) * 0.01).astype(np.float32),
             "b": (rng.standard_normal((4, 128)) * 0.1).astype(np.float32)}
    res = {f"g_{k}": v for k, v in grads.items()}
    state = init_fn({k: v[0] for k, v in grads.items()})
    for call, seed in enumerate((0, 1)):
        o, st = reduce_jit(grads, state, seed)
        for k in grads:
            res[f"out{call}_{k}"] = np.asarray(o[k])
            res[f"stats{call}_{k}"] = np.asarray(st[k])
        state = update_fn(state, st)
        for k in grads:
            res[f"state{call}_{k}"] = np.asarray(state[k])
        for i, k in enumerate(sorted(grads)):
            for r in range(4):
                key = jax.random.fold_in(jax.random.fold_in(
                    jax.random.PRNGKey(seed), i), r)
                res[f"noise_{seed}_{i}_{r}"] = np.asarray(
                    jax.random.uniform(key, grads[k].shape[1:], jnp.float32))
    np.savez(out, **res)
    print("REF_OK")
""")


def _ranks(rank, world, ref_path, out_dir):
    """One rank: the two reference-noise calls, then 30 calls on the
    port's own noise from the updated state."""
    ref = np.load(ref_path)
    grads = {k: torch.from_numpy(ref[f"g_{k}"][rank].copy())
             for k in ("a", "b")}
    own = compress.leaf_noise

    def ref_noise(seed, index, r, shape, device):
        return torch.from_numpy(ref[f"noise_{seed}_{index}_{r}"].copy())

    compress.leaf_noise = ref_noise
    reduce_fn, update_fn, init_fn = compress.make_compressor()
    state = init_fn(grads)
    res = {}
    for call, seed in enumerate(SEEDS):
        out, st = reduce_fn(grads, state, seed)
        state = update_fn(state, st)
        for k in grads:
            res[f"out{call}_{k}"] = out[k]
            res[f"stats{call}_{k}"] = st[k]
            res[f"state{call}_{k}"] = state[k]
    compress.leaf_noise = own
    acc = {k: torch.zeros_like(g) for k, g in grads.items()}
    for s in range(R):
        out, _ = reduce_fn(grads, state, s + 1)
        for k in acc:
            acc[k] += out[k] / R
    res.update({f"acc_{k}": v for k, v in acc.items()})
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _run(tmp_path):
    ref_path = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _REF, str(ref_path)],
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "HOME": str(tmp_path),
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF_OK" in r.stdout
    mesh.spawn_ranks(_ranks, WORLD, tmp_path / "store",
                     args=(str(ref_path), str(tmp_path)))
    return (np.load(ref_path),
            [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)])


def test_compressed_all_reduce_matches_reference(tmp_path):
    ref, ranks = _run(tmp_path)
    for call in range(len(SEEDS)):
        for k in ("a", "b"):
            for what in ("out", "stats", "state"):
                key = f"{what}{call}_{k}"
                for r, got in enumerate(ranks):
                    np.testing.assert_array_equal(
                        got[key].numpy(), ref[key], err_msg=f"{key} rank {r}")
    # the range state tracked the pooled local gradients' range
    for k in ("a", "b"):
        g = ref[f"g_{k}"]
        np.testing.assert_array_equal(
            ranks[0][f"stats0_{k}"].numpy(),
            np.array([g.min(), g.max(), 1.0], np.float32))
        assert float(ranks[0][f"state1_{k}"][2]) == 1.0
    # unbiased: the mean of 30 seeds' reductions is within 5% of the fp32
    # mean (relative to its largest element), on every rank alike
    for k in ("a", "b"):
        true = ref[f"g_{k}"].mean(0)
        scale = np.abs(true).max() + 1e-9
        acc = ranks[0][f"acc_{k}"].numpy()
        assert np.abs(acc - true).max() / scale < 0.05, k
        for got in ranks[1:]:
            np.testing.assert_array_equal(got[f"acc_{k}"].numpy(), acc)


def test_quantize_leaf_is_the_reference_rounding():
    """``_quantize_leaf`` (the stochastic quantizer's operand form with the
    symmetric spec and zero point 0) is ``floor(g / scale + u)`` clipped
    to [-128, 127] bit for bit, with ``g``'s (min, max)."""
    gen = torch.Generator().manual_seed(4)
    g = torch.randn((257, 33), generator=gen) * 0.3
    u = torch.rand((257, 33), generator=gen)
    scale = torch.tensor(0.6 / 127.0)
    q, mn, mx = compress._quantize_leaf(g, scale, u)
    assert q.dtype == torch.int8
    want = torch.clamp(torch.floor(g / scale + u), -128, 127)
    assert torch.equal(q.to(torch.float32), want)
    assert torch.equal(mn, g.min()) and torch.equal(mx, g.max())
    assert int(q.min()) == -128 and int(q.max()) == 127   # some clip
