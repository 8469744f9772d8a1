"""Processes, devices and collectives (counterpart of
`gpv_tpu/parallel/mesh.py`).

The JAX package drives a `jax.sharding.Mesh` from one process per host,
and XLA emits the gradient reductions. Here it is the reference's own
design (`exp/gpv/train_distr.py:170-203`): one process per card, joined
by `torch.distributed`, and `DistributedDataParallel` all-reducing the
gradients (`parallel.train_step`). The JAX package's config keys still
say how to join:

  - `tpu.distributed.{coordinator_address, num_processes, process_id}`,
    the JAX cluster's keys, with one process per card where JAX has one
    per host;
  - or the standard `torchrun` variables (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), which fill the same keys.
    Where both are given and disagree, `initialize_distributed` raises.

The backend is chosen by rule, never as a fallback: NCCL when every rank
of the host has a card of its own, gloo on the CPU and gloo when ranks
share a card (NCCL refuses two ranks on one device). An NCCL failure
raises. Rank-skew points (rank 0's in-train eval, visualisation and
checkpoint writes) wait at `host_barrier`, which runs on a gloo group of
its own with the long `tpu.distributed.barrier_timeout_min`, so a long
eval on rank 0 trips no NCCL collective timeout.

The mesh is (data, model) over the processes, the JAX reshape of the
devices: a model group is `model` consecutive ranks d·model ...
d·model+model-1 (tensor parallelism, `parallel.tensor_parallel`), a data
group the ranks that share a model index (data parallelism). Both kinds of
group are made at the join, on every rank in one order (`new_group` is
collective), with the rank's data and model index (`groups`). With model
1 the data group is the whole world. As the JAX package refuses
multi-host tensor parallelism (`gpv_tpu/parallel/mesh.py:
validate_multihost_mesh`), `model > 1` runs over one host's processes
only, as JAX's runs over one process's devices.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .tensor_parallel import ModelGroup

DATA_AXIS = "data"
MODEL_AXIS = "model"
BARRIER_TIMEOUT_MIN = 720.0  # gpv_tpu/train/trainer.py:76-81

_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_barrier_group = None  # the gloo group of host_barrier, made at the join
_groups = None  # this rank's `Groups`, made at the join


@dataclass(frozen=True)
class Cluster:
    """How this process joins: `address` host:port of rank 0's store,
    `world` processes, this one's `rank`, its `local_rank` on the host and
    the host's `local_world` processes."""
    address: str
    world: int
    rank: int
    local_rank: int
    local_world: int


@dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh over the processes: `data` model groups,
    each of `model` ranks that hold one replica of the model between
    them."""
    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


@dataclass(frozen=True)
class Groups:
    """This rank's place on the mesh: its data and model index, the
    process group of its data peers (the ranks of its model index; the
    world with model 1) and of its model group (None with model 1)."""
    mesh: Mesh
    data_index: int
    model_index: int
    data_group: object
    model_group: object


def _node(cfg, key):
    node = cfg.get(key) if cfg is not None and hasattr(cfg, "get") else None
    return node or {}


def cluster_from_config(tpu_cfg, environ=None) -> Optional[Cluster]:
    """The `Cluster` that `tpu.distributed` and the torchrun variables
    describe, or None for a single process that joins nothing. Raises
    when the two disagree or the config's keys are incomplete."""
    env = os.environ if environ is None else environ
    d = _node(tpu_cfg, "distributed")
    from_cfg = None
    if d.get("coordinator_address"):
        missing = [k for k in ("num_processes", "process_id")
                   if d.get(k) is None]
        if missing:
            raise ValueError(
                "tpu.distributed needs coordinator_address, num_processes "
                f"and process_id; missing: {missing} (got {dict(d)})")
        from_cfg = (str(d["coordinator_address"]), int(d["num_processes"]),
                    int(d["process_id"]))
    from_env = None
    if "WORLD_SIZE" in env or "RANK" in env:
        missing = [k for k in _ENV_KEYS if k not in env]
        if missing:
            raise ValueError(f"torchrun variables incomplete: {missing} "
                             "not set")
        from_env = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                    int(env["WORLD_SIZE"]), int(env["RANK"]))
    if from_cfg and from_env and from_cfg != from_env:
        raise ValueError(
            "tpu.distributed (coordinator_address, num_processes, "
            f"process_id) = {from_cfg} disagrees with the torchrun "
            f"variables (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK) = "
            f"{from_env}; set one of them")
    chosen = from_env or from_cfg
    if chosen is None:
        return None
    address, world, rank = chosen
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    return Cluster(address, world, rank, local_rank, local_world)


def rank_device(cluster: Optional[Cluster], device=None) -> torch.device:
    """The device of this rank: `device`'s type, and for CUDA the card
    `cuda:<local rank mod the host's cards>`. `None` means CUDA."""
    device = torch.device("cuda" if device is None else device)
    if cluster is None or device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("gpv_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", cluster.local_rank % n)


def choose_backend(cluster: Cluster, device: torch.device,
                   n_cards: int) -> tuple:
    """(backend, why): NCCL when every rank of the host has a card of its
    own, gloo on the CPU or when ranks share a card."""
    if device.type != "cuda":
        return "gloo", f"{device.type} ranks"
    if cluster.local_world <= n_cards:
        return "nccl", (f"{cluster.local_world} rank(s) on {n_cards} "
                        "card(s), one card each")
    return "gloo", (f"{cluster.local_world} ranks share {n_cards} card(s); "
                    "NCCL refuses two ranks on one device")


def initialize_distributed(tpu_cfg, device=None,
                           environ=None) -> Optional[Cluster]:
    """Join the process group that `tpu.distributed` or the torchrun
    variables describe (`cluster_from_config`) and return its `Cluster`,
    or None for a single process.

    A second trainer in one process does not join again: a group already
    joined must be the one the config describes."""
    global _barrier_group, _groups
    cluster = cluster_from_config(tpu_cfg, environ)
    if cluster is None:
        return None
    mesh = mesh_from_config(tpu_cfg, cluster.world)
    validate_multihost_mesh(mesh, cluster)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (cluster.world,
                                                        cluster.rank):
            raise ValueError(
                f"this process already joined a group as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}; the config "
                f"asks for rank {cluster.rank} of {cluster.world}")
        if _groups is None or _groups.mesh != mesh:
            raise ValueError(
                f"this process already joined the mesh "
                f"{None if _groups is None else _groups.mesh}; the config "
                f"asks for {mesh}")
        return cluster
    dev = rank_device(cluster, device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, why = choose_backend(cluster, dev, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"gpv_tpu_torch: rank {cluster.rank} of {cluster.world} joins "
          f"tcp://{cluster.address} over {backend} on {dev} ({why})",
          flush=True)
    node = _node(tpu_cfg, "distributed")
    # `timeout_min`: how long a collective may wait before the group fails
    # (torch's default without it)
    kw = ({"timeout": datetime.timedelta(minutes=float(node["timeout_min"]))}
          if node.get("timeout_min") else {})
    dist.init_process_group(backend, init_method=f"tcp://{cluster.address}",
                            world_size=cluster.world, rank=cluster.rank, **kw)
    minutes = float(node.get("barrier_timeout_min", BARRIER_TIMEOUT_MIN)
                    or BARRIER_TIMEOUT_MIN)
    _barrier_group = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(minutes=minutes))
    _groups = _make_groups(mesh, cluster.rank)
    return cluster


def _make_groups(mesh: Mesh, rank: int) -> Groups:
    """This rank's `Groups`. Every rank makes every model group, then
    every data group, in one order (`new_group` is collective)."""
    m = mesh.model
    if m == 1:
        return Groups(mesh, rank, 0, dist.group.WORLD, None)
    model_group = data_group = None
    for d in range(mesh.data):
        g = dist.new_group(list(range(d * m, (d + 1) * m)))
        if rank // m == d:
            model_group = g
    for i in range(m):
        g = dist.new_group(list(range(i, mesh.data * m, m)))
        if rank % m == i:
            data_group = g
    return Groups(mesh, rank // m, rank % m, data_group, model_group)


def validate_multihost_mesh(mesh: Mesh, cluster: Cluster) -> None:
    """Refuse tensor parallelism over more than one host (a cluster whose
    processes are not all on this host), as the JAX package refuses it
    over more than one process, its unit of a host."""
    if mesh.model > 1 and cluster.world != cluster.local_world:
        raise ValueError(
            f"tpu.mesh.model={mesh.model} with {cluster.world} processes on "
            f"more than one host ({cluster.local_world} on this one): "
            "multi-host tensor parallelism is not supported, as in the JAX "
            "package (gpv_tpu/parallel/mesh.py: validate_multihost_mesh), "
            "whose rank-0 checkpointing and eval assume parameters fully "
            "replicated across hosts. Use tpu.mesh.model=1 for multi-host "
            "runs (pure DP, the reference's strategy) or single-host TP.")


def groups() -> Groups:
    """This rank's `Groups`; for a process that joined nothing, the mesh
    of one."""
    if _groups is None or not dist.is_initialized():
        return Groups(Mesh(1, 1), 0, 0, None, None)
    return _groups


def model_group():
    """This rank's model group as a `tensor_parallel.ModelGroup`, or None
    with model 1."""
    g = groups()
    if g.mesh.model == 1:
        return None
    return ModelGroup(g.model_group, g.model_index, g.mesh.model)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return process_index() == 0


def host_barrier() -> None:
    """Wait until every rank gets here (a no-op for one process), on the
    gloo group with `tpu.distributed.barrier_timeout_min`."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=_barrier_group)


def broadcast_from_main(obj):
    """Rank 0's `obj` on every rank (`obj` itself for one process), over
    the barrier's gloo group: the other ranks may wait there while rank 0
    evaluates."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_barrier_group)
    return box[0]


def make_mesh(data: int = -1, model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over `world` processes (default: this group's
    size), one process per card: data·model must be the world; data -1
    means world // model."""
    world = world_size() if world is None else int(world)
    if model < 1:
        raise ValueError(f"tpu.mesh.model={model} < 1")
    if world % model:
        raise ValueError(
            f"tpu.mesh.model={model}: tensor parallelism runs one process "
            f"per card, so it needs a multiple of {model} processes; "
            f"{world} joined (launch with torch.distributed.run "
            "--nproc-per-node N, or set tpu.distributed.*)")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(
            f"tpu.mesh.data={data} x model={model} but {world} process(es) "
            "joined: the mesh is one process per card (launch with "
            "torch.distributed.run --nproc-per-node N, or set "
            "tpu.distributed.*), or data -1")
    return Mesh(data, model)


def mesh_from_config(tpu_cfg, world: Optional[int] = None) -> Mesh:
    m = _node(tpu_cfg, "mesh")
    return make_mesh(int(m.get("data", -1)), int(m.get("model", 1)), world)


def shard_rows(batch_size: int, world: int, rank: int,
               grad_accum: int = 1) -> np.ndarray:
    """The global rows of a batch that `rank` holds (the counterpart of
    `shard_batch`): of each of the `grad_accum` microbatches of
    m = batch_size / grad_accum global rows, the rank's m / world
    contiguous ones, microbatch by microbatch. The JAX step splits the
    global batch into microbatches (`gpv_tpu/parallel/train_step.py:
    147-149`), so microbatch i is global rows [i·m, (i+1)·m) there too."""
    if batch_size % grad_accum:
        raise ValueError(f"batch {batch_size} not divisible by grad_accum "
                         f"{grad_accum}")
    m = batch_size // grad_accum
    if m % world:
        raise ValueError(
            f"microbatch {m} (batch {batch_size} / grad_accum {grad_accum}) "
            f"not divisible by {world} processes")
    lm = m // world
    return np.concatenate([i * m + rank * lm + np.arange(lm)
                           for i in range(grad_accum)])
