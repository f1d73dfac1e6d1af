"""Multi-process runtime on torch.distributed: bring-up, host x chip
meshes, per-shard solves and fleet metrics reduced over processes. The
port of spcies_tpu/parallel/distributed.py.

The reference is single-process and single-thread (no MPI/NCCL). Design:

- `initialize()` brings up torch.distributed's default process group
  (idempotent): from torchrun's environment (MASTER_ADDR, MASTER_PORT,
  WORLD_SIZE, RANK) or from explicit arguments. NCCL where each process
  owns its own cards, gloo on the CPU; processes that share a card pass
  backend="gloo" (NCCL refuses two ranks on one card).
- `host_chip_mesh()` is a (process, local device) grid. Each process
  drives its own row; the other rows are placeholders that give the grid
  its shape.
- `shard_map_solver()` runs each of this process's shards through its
  replica's BatchedSolver.__call__: termination is per shard and no
  collective sits in the solve, so processes never wait on each other
  while they solve.
- `global_fleet_metrics()` reduces converged counts and iteration
  statistics over every process with two all_reduce calls, off the hot
  path; every process returns the same values.

Multi-process bring-up (one process per card, under torchrun):

    import spcies_tpu_torch as sp
    sp.parallel.initialize()
    mesh = sp.parallel.host_chip_mesh()          # (processes, 1)
    solver = sp.make_solver(...)
    solve = sp.parallel.shard_map_solver(solver, mesh)
    x0 = sp.parallel.from_process_local(mesh, x0_local)
    res = solve(x0, xr, ur)                      # this process's lanes
    print(sp.parallel.global_fleet_metrics(res, mesh))

tests/test_torch_multiprocess.py runs this flow in 2 and 4 CPU processes
over gloo.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from spcies_tpu_torch.api import _canonical_device, resolve_device
from spcies_tpu_torch.parallel.mesh import (Mesh, ProcessLocal, ShardedSolve,
                                            _split, fleet_metrics)

# torchrun's variables that name a cluster
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# The devices `initialize(local_device_ids=...)` gave this process, read
# by host_chip_mesh; process-wide, like the process group itself.
_LOCAL_DEVICES: list = []


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _as_device(d) -> torch.device:
    """A local device id: an int is that card, else any torch.device
    argument."""
    if isinstance(d, int):
        d = torch.device("cuda", d)
    return _canonical_device(resolve_device(d))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, *, backend: str | None = None) -> bool:
    """Bring up torch.distributed's default process group (idempotent).

    With no arguments it reads torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK): where none is set it returns False and
    initializes nothing, the single-process case; where some are set and
    others not, it raises ValueError. For a manual bring-up pass the
    coordinator's 'host:port', the process count and this process's id.
    local_device_ids (card indices, or devices such as "cpu") are the
    devices this process drives, which host_chip_mesh takes by default.
    backend: 'nccl' where a card is visible and the local devices (if
    given) are cards, else 'gloo'; processes that share a card need
    'gloo'. A failed bring-up raises; nothing falls back
    to a single process. Returns True where the group has more than one
    process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if (coordinator_address, num_processes, process_id) == (None,) * 3:
        present = [k for k in LAUNCHER_ENV if os.environ.get(k)]
        if not present:
            return False
        missing = [k for k in LAUNCHER_ENV if k not in present]
        if missing:
            raise ValueError(
                f"the environment names a cluster ({', '.join(present)}) "
                f"but not {', '.join(missing)}")
        init = dict(init_method="env://",
                    world_size=int(os.environ["WORLD_SIZE"]),
                    rank=int(os.environ["RANK"]))
    elif None in (coordinator_address, num_processes, process_id):
        raise ValueError("a manual bring-up takes coordinator_address, "
                         "num_processes and process_id together")
    else:
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
    _LOCAL_DEVICES[:] = ([] if local_device_ids is None
                         else [_as_device(d) for d in local_device_ids])
    if backend is None:
        on_cards = torch.cuda.is_available() and all(
            d.type == "cuda" for d in _LOCAL_DEVICES)
        backend = "nccl" if on_cards else "gloo"
    if backend == "nccl":
        # NCCL's collectives run on the process's current card
        torch.cuda.set_device(_local_devices()[0])
    dist.init_process_group(backend, **init)
    return dist.get_world_size() > 1


def is_distributed() -> bool:
    return _process_count() > 1


def _local_devices() -> list:
    """This process's devices: those initialize was given, else
    LOCAL_RANK's card under torchrun, else every visible card."""
    if _LOCAL_DEVICES:
        return list(_LOCAL_DEVICES)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError(
            "no CUDA device: host_chip_mesh takes this process's cards by "
            "default; pass devices=[\"cpu\", ...] for logical shards on "
            "the CPU")
    if os.environ.get("LOCAL_RANK"):
        return [_as_device(int(os.environ["LOCAL_RANK"]))]
    return [_as_device(i) for i in range(count)]


def _reduce_device() -> torch.device:
    """Where the group's collectives take their tensors: this process's
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_chip_mesh(axis_names: tuple[str, str] = ("host", "chip"),
                   devices=None) -> Mesh:
    """2-D (process, device) mesh: row p holds process p's devices, this
    process's own (`devices`, by default those initialize was given, or
    LOCAL_RANK's card under torchrun, or every visible card) and None for
    the other processes' entries. Every process must drive as many
    devices: one all_gather checks it where the group has more than one
    process. Single-process it is (1, local)."""
    local = ([_as_device(d) for d in devices] if devices is not None
             else _local_devices())
    world, rank = _process_count(), _process_index()
    if world > 1:
        dev = _reduce_device()
        counts = [torch.zeros(1, dtype=torch.int64, device=dev)
                  for _ in range(world)]
        dist.all_gather(counts, torch.tensor([len(local)],
                                             dtype=torch.int64, device=dev))
        if any(int(c) != len(local) for c in counts):
            raise ValueError("host_chip_mesh requires the same device "
                             "count on every host")
    grid = np.empty((world, len(local)), dtype=object)
    grid[rank] = local
    return Mesh(grid, axis_names)


def batch_spec(mesh: Mesh) -> tuple:
    """The axes the batch is sharded over: every axis of the mesh (the
    JAX package's PartitionSpec((axis names)))."""
    return tuple(mesh.axis_names)


def from_process_local(mesh: Mesh, local_array,
                       global_batch: int | None = None) -> ProcessLocal:
    """This process's lanes [B_local, ...] of a batch of global_batch
    lanes (by default B_local x processes), tagged with their offset: the
    lanes of the mesh entries this process drives. Each process feeds its
    own scenarios."""
    entries = mesh.local_entries
    B_local = int(np.shape(local_array)[0])
    if global_batch is None:
        global_batch = B_local * _process_count()
    per = _split(int(global_batch), mesh.size, "global batch")
    if B_local != per * len(entries):
        raise ValueError(
            f"{B_local} process-local lanes; this process's "
            f"{len(entries)} of {mesh.size} mesh entries hold "
            f"{per * len(entries)} of {global_batch}")
    return ProcessLocal(local_array, entries[0][0] * per, int(global_batch))


def shard_map_solver(solver, mesh: Mesh, *, donate: bool = False):
    """The solver over `mesh`'s shards, per-shard termination, no
    collective in the solve (`mesh.ShardedSolve`): this process solves the
    lanes of the entries it drives, each through its replica's __call__.

    Returns solve(*inputs, init=None, fixed_iters=None) -> SolveResult of
    this process's lanes. Inputs are what from_process_local returned, or
    full [B_global, ...] arrays (this process takes its slice); init's
    arrays may also be this process's lanes (the previous result's
    iterates). B_global must divide evenly by mesh.size. `donate` is
    accepted for the JAX package's signature and does nothing: no buffer
    is donated.

    Per-lane results equal a separate solve of each shard's lanes bit for
    bit. Against one solve of the whole batch they are equal in the
    checked and exact-k modes, up to the rounding of the adapters'
    products, which may depend on the batch's shape; in plain free-run
    (check_every > 1 without exact_k) a lane's reported k depends on the
    other lanes of its group of 8 (the kernels drain a group at once, and
    sort_lanes reorders lanes before tiling), so it may differ there."""
    del donate
    return ShardedSolve(solver, mesh)


def global_fleet_metrics(result, mesh: Mesh | None = None) -> dict:
    """fleet_metrics over every process's lanes, with n_hosts (processes)
    and n_devices (mesh.size, else the sum of each process's devices):
    two all_reduce calls (a SUM of the converged count, the sum of k, the
    lane count and the device count; a MAX of k, of -k and of the lane
    count and its negative, which must agree: every process holds as many
    lanes, as shard_map_solver gives them). Every process returns the same
    values. Single-process it is fleet_metrics with n_hosts 1."""
    local = fleet_metrics(result)
    n_dev = (len(mesh.local_entries) if mesh is not None
             else len(_local_devices()) if torch.cuda.is_available() else 1)
    if not dist.is_initialized():
        return dict(local, n_hosts=1,
                    n_devices=mesh.size if mesh is not None else n_dev)
    dev = _reduce_device()
    lanes = local["n_lanes"]
    sums = torch.tensor([local["n_converged"], int(result.k.long().sum()),
                         lanes, n_dev], dtype=torch.int64, device=dev)
    maxs = torch.tensor([local["k_max"], -local["k_min"], lanes, -lanes],
                        dtype=torch.int64, device=dev)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(maxs, op=dist.ReduceOp.MAX)
    n_conv, k_sum, n_lanes, n_dev_all = sums.tolist()
    k_max, neg_k_min, most, neg_least = maxs.tolist()
    if most != -neg_least:
        raise ValueError(f"processes hold {-neg_least} to {most} lanes; "
                         f"global_fleet_metrics reduces equal shards")
    return dict(n_lanes=n_lanes, n_converged=n_conv,
                k_mean=k_sum / n_lanes, k_max=k_max, k_min=-neg_k_min,
                n_hosts=dist.get_world_size(),
                n_devices=mesh.size if mesh is not None else n_dev_all)
