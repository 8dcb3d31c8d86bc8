"""The process layout: one process a device, on a (data, fsdp, model) mesh.

The JAX package runs one controller a host over a ``jax.sharding.Mesh``
with the axes

  data  — data parallelism (the gradients summed over it);
  fsdp  — data parallelism whose parameters and optimizer state are also
          sharded over it;
  model — tensor parallelism (or, in the JAX package, the pipeline,
          context or expert strategy that holds that axis).

Here each device is a process of ``torch.distributed``, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the same
three dims.  Rank r sits at ``np.unravel_index(r, (data, fsdp, model))``:
the JAX package's ``devices.reshape(data, fsdp, model)`` puts device r at
the same coordinate, so the model dim is innermost and a tensor-parallel
group is made of neighbouring ranks.  ``ProcessMesh`` holds the layout, this
rank's coordinate and a process group per dim, plus ``batch`` (the
data x fsdp ranks of one model coordinate, over which the batch is split
and the gradients summed) and ``world``.  Without an initialised process
group the mesh is one process and every group is None; the collectives of
``parallel/comm.py`` are then the identity.

``initialize_distributed`` starts the process group on a TCP store at the
coordinator address (the JAX CLI's ``--coordinator-address``,
``--num-processes``, ``--process-id``): NCCL for CUDA devices, gloo for the
CPU, or the backend the caller names.  ``coordination_barrier`` waits for
every process on the host side, with a timeout.
"""

import datetime
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "model")


@dataclass
class MeshConfig:
    data_parallel: int = -1  # -1 = every process the other dims leave
    fsdp: int = 1
    tensor_parallel: int = 1


def mesh_shape(cfg: MeshConfig, world: int) -> Tuple[int, int, int]:
    """(data, fsdp, model) for ``world`` processes.  Every process takes a
    place: the port has no idle ranks, where the JAX package may leave
    devices out of its mesh."""
    tp, fs = max(cfg.tensor_parallel, 1), max(cfg.fsdp, 1)
    dp = cfg.data_parallel
    if dp == -1:
        if world % (tp * fs):
            raise ValueError(f"{world} processes not divisible by fsdp*tp={fs * tp}")
        dp = world // (tp * fs)
    if dp * fs * tp != world:
        raise ValueError(f"mesh {dp}x{fs}x{tp} needs {dp * fs * tp} processes, not {world}")
    return dp, fs, tp


def rank_coord(rank: int, shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The (data, fsdp, model) coordinate of ``rank``: model innermost, as
    the JAX package's ``build_mesh`` lays devices out."""
    return tuple(int(i) for i in np.unravel_index(rank, shape))


def model_axis_size(dist_cfg) -> int:
    """Size of the shared 'model' axis given the distributed flags.  At most
    one model-parallel strategy may exceed 1 (the reference likewise keeps a
    single model-parallel group, distributed/utils.py:491-508)."""
    sizes = {
        "tensor_parallel": max(getattr(dist_cfg, "tensor_parallel", 1), 1),
        "pipeline_parallel": max(getattr(dist_cfg, "pipeline_parallel", 1), 1),
        "context_parallel": max(getattr(dist_cfg, "context_parallel", 1), 1),
        "moe_experts": max(getattr(dist_cfg, "moe_experts", 0), 1),
    }
    active = {k: v for k, v in sizes.items() if v > 1}
    if len(active) > 1:
        raise ValueError(f"at most one model-parallel strategy may exceed 1, got {active}")
    return max(sizes.values())


class ProcessMesh:
    """This process's place on the (data, fsdp, model) mesh and a group per
    dim.  ``group(axis)`` is None where the mesh is one process."""

    def __init__(self, shape: Tuple[int, int, int], rank: int = 0,
                 device: Union[str, torch.device] = "cpu", join: bool = True):
        """``join=False``: a mesh of its own, without groups, whatever
        process group runs (a one-process trainer beside a distributed one)."""
        self.shape: Dict[str, int] = dict(zip(AXES, shape))
        self.world = int(np.prod(shape))
        self.rank = rank
        self.device = torch.device(device)
        self.coord: Dict[str, int] = dict(zip(AXES, rank_coord(rank, shape)))
        self.device_mesh = None
        self._groups: Dict[str, Optional[object]] = {a: None for a in AXES + ("batch", "world")}
        self.host_group = None
        if join and dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != self.world:
                raise ValueError(f"mesh of {self.world} processes in a world of "
                                 f"{dist.get_world_size()}")
            self._build_groups()

    def _build_groups(self) -> None:
        from torch.distributed.device_mesh import DeviceMesh

        ranks = torch.arange(self.world).reshape(tuple(self.shape.values()))
        self.device_mesh = DeviceMesh(self.device.type, ranks, mesh_dim_names=AXES)
        for axis in AXES:
            self._groups[axis] = self.device_mesh.get_group(axis)
        self._groups["world"] = dist.group.WORLD
        # the batch group: every (data, fsdp) rank of one model coordinate;
        # new_group is collective, so every rank creates every such group
        for m in range(self.shape["model"]):
            members = ranks[..., m].flatten().tolist()
            g = (dist.group.WORLD if self.shape["model"] == 1
                 else dist.new_group(members))
            if self.coord["model"] == m:
                self._groups["batch"] = g
        # barriers and host-side flags wait on the CPU, whatever the backend
        self.host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))

    def size(self, axis: str) -> int:
        if axis == "batch":
            return self.shape["data"] * self.shape["fsdp"]
        if axis == "world":
            return self.world
        return self.shape[axis]

    def index(self, axis: str) -> int:
        if axis == "batch":
            return self.coord["data"] * self.shape["fsdp"] + self.coord["fsdp"]
        if axis == "world":
            return self.rank
        return self.coord[axis]

    def group(self, axis: str):
        return self._groups[axis]

    @property
    def distributed(self) -> bool:
        return self._groups["world"] is not None

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank}, coord={self.coord})"


def build_mesh(cfg: Optional[MeshConfig] = None,
               device: Union[str, torch.device, None] = None) -> ProcessMesh:
    """The mesh over the processes of the initialised process group (one
    process when there is none)."""
    cfg = cfg or MeshConfig()
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    return ProcessMesh(mesh_shape(cfg, world), rank, device or "cpu")


def mesh_from_config(dist_cfg, device: Union[str, torch.device, None] = None) -> ProcessMesh:
    return build_mesh(MeshConfig(data_parallel=getattr(dist_cfg, "data_parallel", -1),
                                 fsdp=getattr(dist_cfg, "fsdp", 1),
                                 tensor_parallel=model_axis_size(dist_cfg)), device)


def default_device(process_id: int = 0) -> torch.device:
    """``cuda:{process_id % cards}``: one card a process where the host has
    as many, else the processes share the cards in turn."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: int = 1,
                           process_id: int = 0, device: Union[str, torch.device] = "cuda",
                           backend: Optional[str] = None) -> None:
    """Start the process group (reference distributed_init,
    utils.py:243-332): a no-op for one process.  The rendezvous is a TCP
    store at ``coordinator_address`` ("host:port", rank 0 listens; an
    address with a scheme, such as "file:///shared/path", is passed to
    torch as it is).  The backend is NCCL for a CUDA device and gloo for
    the CPU unless ``backend`` names one: NCCL takes one rank a card, so
    processes that share a card name gloo."""
    if num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("--coordinator-address is needed for more than one process")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **kw)
    logger.info("process %d of %d (%s, %s)", process_id, num_processes, backend, device)


def shutdown_distributed() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def coordination_barrier(name: str, timeout_s: float = 600.0,
                         mesh: Optional[ProcessMesh] = None) -> None:
    """Block until every process reaches this barrier, on the host (a gloo
    ``monitored_barrier``, which names the ranks that did not arrive), not
    through a device collective.  A no-op for one process."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    group = mesh.host_group if mesh is not None else None
    if group is None and dist.get_backend() != "gloo":
        dist.barrier()
        return
    try:
        dist.monitored_barrier(group=group, timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def local_batch_slice(global_batch: int, mesh: ProcessMesh) -> int:
    """Rows this process loads and steps on: the global batch over the
    data x fsdp ranks (the ranks of a tensor-parallel group take the same
    rows)."""
    n = mesh.size("batch")
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data*fsdp={n}")
    return global_batch // n


def batch_rows(global_batch: int, mesh: ProcessMesh, update_freq: int = 1) -> np.ndarray:
    """The rows of a global batch that this rank takes, as the JAX package
    shards a batch laid out (update_freq, microbatch): of each microbatch,
    the contiguous block of its (data, fsdp) coordinate."""
    ufreq = max(update_freq, 1)
    if global_batch % ufreq:
        raise ValueError(f"batch {global_batch} not divisible by update_freq {ufreq}")
    micro = global_batch // ufreq
    per = local_batch_slice(micro, mesh)
    start = mesh.index("batch") * per
    return np.concatenate([i * micro + start + np.arange(per) for i in range(ufreq)])
