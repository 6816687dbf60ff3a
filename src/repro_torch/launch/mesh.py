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
    """A rank's place in a ``(pod, data, model)`` mesh: its data subgroup
    (the ranks of its pod and model coordinates: ZeRO-3 storage), its
    model subgroup (the ranks of its pod and data coordinates), its
    coordinates and the mesh's sizes; its batch subgroup (the ranks of
    its model coordinate: the batch is split over ``(pod, data)``) and its
    pod subgroup (the ranks of its data and model coordinates).  With one
    pod the batch group is the data group and there is no pod group."""

    data: object
    model: object
    coords: dict
    sizes: dict
    batch: object = None
    pod: object = None


def mesh_groups(data: int, model: int, pod: int = 1) -> MeshGroups:
    """This rank's subgroups of a ``(pod, data, model)`` mesh over the
    default process group (world size ``pod * data * model``), in
    ``jax.make_mesh``'s row-major order: ``rank = (p * data + d) * model
    + m``.  Every rank must call it (``torch.distributed.new_group`` is
    collective).  ``pod = 1`` is the ``(data, model)`` mesh: coordinates
    and sizes without a ``"pod"`` entry, the batch group the data
    group."""
    world = pod * data * model
    if dist.get_world_size() != world:
        shape = (data, model) if pod == 1 else (pod, data, model)
        raise ValueError(f"a {shape} mesh needs {world} ranks, not "
                         f"{dist.get_world_size()}")

    def rank(p, d, m):
        return (p * data + d) * model + m
    pd, m = divmod(dist.get_rank(), model)
    p, d = divmod(pd, data)
    data_groups = [[dist.new_group([rank(pp, dd, mm) for dd in range(data)])
                    for mm in range(model)] for pp in range(pod)]
    model_groups = [[dist.new_group([rank(pp, dd, mm) for mm in range(model)])
                     for dd in range(data)] for pp in range(pod)]
    coords, sizes = {"data": d, "model": m}, {"data": data, "model": model}
    if pod == 1:
        g = data_groups[0][m]
        return MeshGroups(g, model_groups[0][d], coords, sizes, g, None)
    batch_groups = [dist.new_group([rank(pp, dd, mm) for pp in range(pod)
                                    for dd in range(data)])
                    for mm in range(model)]
    pod_groups = [[dist.new_group([rank(pp, dd, mm) for pp in range(pod)])
                   for mm in range(model)] for dd in range(data)]
    return MeshGroups(data_groups[p][m], model_groups[p][d],
                      {"pod": p, **coords}, {"pod": pod, **sizes},
                      batch_groups[m], pod_groups[d][m])


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
