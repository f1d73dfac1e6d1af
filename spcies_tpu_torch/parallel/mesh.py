"""Scenario-batch sharding over the devices of one process: the port of
spcies_tpu/parallel/mesh.py.

The reference is entirely serial (one embedded problem per binary, no
MPI/NCCL). Here the batch dimension shards over a `Mesh` of devices, each
shard solved by a replica of the solver on its device, and fleet metrics
(converged counts, iteration statistics) are reduced off the hot path.

Unlike the JAX package's `sharded_solver`, which leaves the partitioning
to jit (and whose convergence-checked loop then tests "any lane active"
with a cross-device all-reduce every iteration), every shard here runs
its own solve: termination is per shard and no collective sits in the
loop. Under the solvers' freeze semantics (converged lanes stop moving)
the per-lane results do not depend on where a loop stops, so the two
agree lane by lane; what a lane's result may depend on (the kernels'
8-lane groups in plain free-run, the batch shape of a product's rounding)
is said in `shard_map_solver`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from spcies_tpu_torch.api import _canonical_device, _replica, resolve_device
from spcies_tpu_torch.solvers.common import SolveResult


class Mesh:
    """A grid of devices with named axes, the port's counterpart of
    jax.sharding.Mesh for scenario-batch sharding.

    devices: a numpy object array of torch.device, one axis a name
    (axis_names). A device may repeat: logical shards on one card, or on
    the CPU, the only way to have more than one shard there (the JAX
    tests' virtual CPU devices). An entry that another process drives is
    None (`host_chip_mesh`): only the grid's shape reads it.

    A batch is sharded over the entries in row-major order: entry i of
    `devices.ravel()` takes the i-th of `size` contiguous, equal chunks.
    torch.distributed's DeviceMesh maps one rank to one device, where a
    JAX process (and this mesh) drives all of its host's devices.
    """

    def __init__(self, devices, axis_names):
        given = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if given.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {given.shape} takes "
                             f"{given.ndim} axis names; got {axis_names}")
        if given.size == 0:
            raise ValueError("a mesh needs at least one device")
        grid = np.empty(given.size, dtype=object)
        for i, d in enumerate(given.ravel()):
            grid[i] = None if d is None else _canonical_device(
                resolve_device(d))
        self.devices = grid.reshape(given.shape)
        self.axis_names = axis_names

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        """Axis name -> length, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_entries(self) -> list:
        """(flat index, device) of each entry this process drives."""
        return [(i, d) for i, d in enumerate(self.devices.ravel())
                if d is not None]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def batch_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over every visible card, or over `devices` (any
    torch.device or string; repeats allowed, e.g. ["cpu"] * 4 or
    ["cuda:0"] * 4). Without a card the default raises; it does not fall
    back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError(
                "no CUDA device: batch_mesh takes every visible card by "
                "default; pass devices=[\"cpu\", ...] for logical shards "
                "on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(list(devices), (axis_name,))


def _split(n: int, parts: int, what: str) -> int:
    """Lanes of each of `parts` equal chunks of n; ValueError unless n
    divides evenly."""
    if n % parts:
        raise ValueError(f"{what} {n} must be divisible by mesh size "
                         f"{parts} for sharded solves")
    return n // parts


def shard_batch(mesh: Mesh, *arrays) -> list:
    """Split each [B, ...] array's leading batch dimension into mesh.size
    contiguous chunks, chunk i on entry i of the mesh: one list of
    tensors an array. B must divide evenly by mesh.size."""
    entries = [d for _, d in _local_mesh(mesh)]
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        per = _split(t.shape[0], mesh.size, "batch")
        out.append([c.to(d) for c, d in zip(torch.split(t, per), entries)])
    return out


def _local_mesh(mesh: Mesh) -> list:
    """The mesh's entries, every one of which this process must drive."""
    entries = mesh.local_entries
    if len(entries) != mesh.size:
        raise ValueError("this mesh spans processes; solve over it with "
                         "parallel.shard_map_solver")
    return entries


@dataclasses.dataclass(frozen=True)
class ProcessLocal:
    """This process's lanes of a batch sharded over a mesh:
    data[B_local, ...] are lanes offset .. offset + B_local of a global
    batch of global_batch lanes (`distributed.from_process_local`)."""

    data: Any
    offset: int
    global_batch: int


class ShardedSolve:
    """`solve(*inputs, init=None, fixed_iters=None) -> SolveResult` over
    the entries of `mesh` this process drives, each shard through the
    `__call__` of the solver's replica on its device (api._replica), so
    that defaults, engineering units and the precision pin hold on every
    shard. Replicas are built once, one a distinct device.

    Each batched input (and each array of `init`) is [B_global, ...] (this
    process takes its own lanes), this process's [B_local, ...] lanes
    (a `ProcessLocal`, or an array of B_local lanes, such as the previous
    result's iterates for a warm start), or a single problem or a batch
    of one, which every lane shares. B_global must divide evenly by
    mesh.size. The result holds this process's lanes, in order, on its
    first device; a `sol` entry that is not a batched tensor (times_ms)
    becomes the list of the shards' entries.

    Every shard's solve is enqueued before any output is gathered, so
    shards on distinct cards run at once; options.timing synchronises
    each shard's card at its marks, which serialises them. No
    torch.distributed collective is called here."""

    def __init__(self, solver, mesh: Mesh):
        self.solver = solver
        self.mesh = mesh
        self.entries = mesh.local_entries
        flat = [i for i, _ in self.entries]
        if flat != list(range(flat[0], flat[0] + len(flat))):
            raise ValueError("this process's mesh entries must be "
                             "contiguous in the mesh's row-major order")
        built = {}
        for _, d in self.entries:
            if d not in built:
                built[d] = _replica(solver, d)
        self.replicas = [built[d] for _, d in self.entries]

    def _global_batch(self, arrays) -> int:
        """B_global: the tag of a ProcessLocal input, else the largest
        leading dimension of the batched inputs (as the JAX package's
        shard_map_solver finds it)."""
        tags = {a.global_batch for a in arrays if isinstance(a, ProcessLocal)}
        if len(tags) > 1:
            raise ValueError(f"process-local inputs of different global "
                             f"batches {sorted(tags)}")
        if tags:
            return tags.pop()
        sizes = [int(np.shape(a)[0]) for a, cnd in zip(
            arrays, self.solver.input_core_ndims) if np.ndim(a) == cnd + 1]
        return max(sizes, default=1)

    def _local_part(self, a, core_ndim, B_global, offset, B_local):
        """This process's lanes of one input or init array, or the array
        itself where every lane shares it."""
        if isinstance(a, ProcessLocal):
            if (a.global_batch, a.offset) != (B_global, offset):
                raise ValueError(
                    f"process-local lanes at offset {a.offset} of "
                    f"{a.global_batch}; this process holds offset {offset} "
                    f"of {B_global}")
            a = a.data
        if np.ndim(a) != core_ndim + 1 or np.shape(a)[0] == 1:
            return a
        rows = int(np.shape(a)[0])
        if rows == B_global:
            return a[offset:offset + B_local]
        if rows == B_local:
            return a
        raise ValueError(f"an array of {rows} lanes in a solve of "
                         f"{B_global} lanes ({B_local} in this process)")

    def __call__(self, *inputs, init=None, fixed_iters=None):
        size, n_local = self.mesh.size, len(self.entries)
        B_global = self._global_batch(inputs)
        per = _split(B_global, size, "global batch")
        offset, B_local = self.entries[0][0] * per, n_local * per
        cores = self.solver.input_core_ndims
        local = [self._local_part(a, c, B_global, offset, B_local)
                 for a, c in zip(inputs, cores)]
        if init is not None:
            # an init array holds one row a lane: rank 2 for the vector
            # iterates (1 where shared by every lane)
            init = [self._local_part(a, 1, B_global, offset, B_local)
                    for a in init]

        def shard(a, j, core_ndim):
            if np.ndim(a) != core_ndim + 1 or np.shape(a)[0] == 1:
                return a
            return a[j * per:(j + 1) * per]

        results = []
        for j, replica in enumerate(self.replicas):
            results.append(replica(
                *(shard(a, j, c) for a, c in zip(local, cores)),
                init=(None if init is None
                      else tuple(shard(a, j, 1) for a in init)),
                fixed_iters=fixed_iters))
        return _merge_results(results, self.entries[0][1])


def _merge_results(results, device) -> SolveResult:
    """The shards' results as one SolveResult on `device`, lanes in shard
    order."""
    if len(results) == 1:
        return results[0]

    def cat(values):
        if all(torch.is_tensor(v) and v.ndim >= 1 for v in values):
            return torch.cat([v.to(device) for v in values])
        return list(values)

    first = results[0]
    return SolveResult(
        u=cat([r.u for r in results]), k=cat([r.k for r in results]),
        e_flag=cat([r.e_flag for r in results]),
        sol={key: cat([r.sol[key] for r in results]) for key in first.sol})


def sharded_solver(solver, mesh: Mesh):
    """The solver with its batch sharded over `mesh`, whose every entry
    this process drives (`batch_mesh`): each shard runs the whole solve
    on its device through a replica's `__call__` (`ShardedSolve`), with
    per-shard termination and no collective. Returns
    solve(*inputs, init=None, fixed_iters=None) -> SolveResult."""
    _local_mesh(mesh)
    return ShardedSolve(solver, mesh)


def fleet_metrics(result, mesh: Mesh | None = None) -> dict:
    """Solve metrics of a result's lanes (this process's, for a sharded
    result): lanes, converged lanes, mean, largest and least k. The
    reduction over processes is `distributed.global_fleet_metrics`;
    `mesh` is accepted for the JAX package's signature."""
    k, e = result.k, result.e_flag
    if k.numel() == 0:
        raise ValueError("fleet_metrics of a result without lanes")
    return dict(
        n_lanes=int(k.shape[0]),
        n_converged=int((e == 1).sum()),
        k_mean=int(k.long().sum()) / int(k.shape[0]),
        k_max=int(k.max()),
        k_min=int(k.min()),
    )
