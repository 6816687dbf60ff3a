"""Device meshes and rank processes (port of ``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (never a module constant): importing
this module touches no process group.  A ``DeviceMesh`` needs
``torch.distributed`` initialized with one rank per device of the mesh;
nothing on a machine tells a program of its cluster, so the launcher
passes the group's address (or a store), world size and rank itself, as
:func:`spawn_ranks` does for the processes of one host.

The reference's TPU v5e constants (peak FLOP/s, HBM and ICI rates) are not
carried over: they are a TPU's numbers.
"""
from __future__ import annotations

import os
from typing import Callable, NamedTuple, Sequence

import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    default process group (its world size is the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production meshes: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


class MeshGroups(NamedTuple):
    """A rank's place in a ``(data, model)`` mesh: its data subgroup (the
    ranks of its model coordinate), its model subgroup (the ranks of its
    data coordinate), its coordinates and the mesh's sizes."""

    data: object
    model: object
    coords: dict
    sizes: dict


def mesh_groups(data: int, model: int) -> MeshGroups:
    """This rank's subgroups of a ``(data, model)`` mesh over the default
    process group (world size ``data * model``), in ``jax.make_mesh``'s
    row-major order: ``rank = d * model + m``.  Every rank must call it
    (``torch.distributed.new_group`` is collective)."""
    if dist.get_world_size() != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, not {dist.get_world_size()}")
    d, m = divmod(dist.get_rank(), model)
    data_groups = [dist.new_group([dd * model + mm for dd in range(data)])
                   for mm in range(model)]
    model_groups = [dist.new_group([dd * model + mm for mm in range(model)])
                    for dd in range(data)]
    return MeshGroups(data_groups[m], model_groups[d],
                      {"data": d, "model": m}, {"data": data, "model": model})


def dp_axes(multi_pod: bool = False) -> tuple:
    """The data-parallel (batch) mesh axes."""
    return ("pod", "data") if multi_pod else ("data",)


def num_chips(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def _rank_main(rank: int, fn: Callable, world: int, store_path: str,
               backend: str, args: tuple) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, store_path, *,
                backend: str = "gloo", args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one process group through a ``FileStore`` at ``store_path`` (a fresh
    file); ``fn`` must be importable by name.  Waits for every rank, and
    raises if one fails (the others are stopped)."""
    import torch.multiprocessing as mp
    store_path = os.fspath(store_path)
    if os.path.exists(store_path):
        os.remove(store_path)
    mp.start_processes(_rank_main,
                       args=(fn, world, store_path, backend, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
