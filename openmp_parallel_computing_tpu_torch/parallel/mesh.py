"""Device mesh topology (port of ``openmp_parallel_computing_tpu.parallel.
mesh``).

The reference's parallelism knob is a thread count (``OMP_NUM_THREADS``,
swept by ``monolithic/scripts/bench_and_plot_monolithic.sh:34-46``). Here
it is a mesh: devices arranged into a ``data`` axis (independent work
items: scenario batches, frame batches) and a ``model`` axis (within one
work item: a frame's rows), as in the JAX package.

The port's mesh is a single controller, as JAX's is within one process:
one Python process holds a grid of ``torch.device``s and drives every
shard of it in turn (``parallel.collectives`` moves the data between
them). A device may repeat in the grid: ``[torch.device("cuda", 0)] * 8``
is a mesh of eight logical shards on one card, and the CPU tests build
``[torch.device("cpu")] * 8``. The mesh never makes up devices on its own
and never falls back to the CPU: with no ``devices`` it takes the attached
cards (``default_devices``), and raises when there are none.

The multi-host tier (``initialize_multihost``) adds processes, one
``torch.distributed`` rank each: the data axis then spans the processes
and the model axis stays inside each one.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# "data" shards independent work items (the analogue of the reference's
# queue-sharded jobs); "model" shards within one work item (a frame's
# rows: the analogue of OpenMP threads inside one kernel).
DATA_AXIS = "data"
MODEL_AXIS = "model"


def default_devices() -> list[torch.device]:
    """The attached cards, ``cuda:0 .. n-1`` (empty without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_count() -> int:
    """The process group's world size, or 1 outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Mesh:
    """A (data, model) grid of torch devices.

    ``devices[i][j]`` is this process's shard at data row i, model column
    j. ``shape`` is the global shape, as JAX's: the data axis counts the
    rows of every process. ``flat`` lists this process's devices data-row
    by data-row, the order in which a batch sharded over (data, model)
    (JAX's ``P((DATA, MODEL))``) is laid out.
    """

    def __init__(self, devices, processes: int = 1):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.processes = processes

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices) * self.processes,
                MODEL_AXIS: len(self.devices[0])}

    @property
    def local_shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        """This process's shard count."""
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list[torch.device]:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[[str(d) for d in row] for row in self.devices]}, "
                f"processes={self.processes})")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: how many devices along each named axis.

    ``data=-1`` means "all remaining devices". Build with ``spec.build()``.
    """

    data: int = -1
    model: int = 1

    def build(self, devices=None) -> Mesh:
        """A mesh over ``devices`` (this process's; default: the attached
        cards), taking the first data x model of them row by row, as JAX
        does. Across processes the global device list is every process's
        list in rank order, as JAX orders it, and the mesh must take all
        of them (the port's collectives need an equal share a process);
        raises ``ValueError`` when there are too few devices or a model
        group would cross processes."""
        devices = list(devices) if devices is not None else default_devices()
        if not devices:
            raise ValueError("no devices for a mesh: no CUDA card is "
                             "attached, and a mesh never falls back to the "
                             "CPU (pass devices= to build one there)")
        nproc = process_count()
        n = len(devices) * nproc
        model = self.model
        data = self.data if self.data != -1 else max(1, n // model)
        if data * model > n:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"devices, have {n}")
        if nproc > 1 and len(devices) % model:
            raise ValueError(f"mesh {data}x{model}: a model group would "
                             f"cross processes of {len(devices)} devices")
        if nproc > 1 and data * model != n:
            raise ValueError(f"mesh {data}x{model} over {nproc} processes "
                             f"must take all {n} devices")
        local = data // nproc
        grid = [devices[i * model:(i + 1) * model] for i in range(local)]
        return Mesh(grid, processes=nproc)


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh over the attached (or given) devices."""
    return MeshSpec(data=data, model=model).build(devices)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where ``device_put`` lays a tensor: split along dim 0 over the data
    axis (``split``) or whole on every device."""

    mesh: Mesh
    split: bool


def data_sharding(mesh: Mesh, ndim: int = 1) -> Placement:
    """Shard the leading axis over ``data``, replicate the rest (over the
    model axis too), as JAX's ``P(DATA, None, ...)``. ``ndim`` is kept for
    the JAX signature; the split is along dim 0 whatever the rank."""
    del ndim
    return Placement(mesh, split=True)


def replicated(mesh: Mesh) -> Placement:
    """A whole copy on every device of the mesh."""
    return Placement(mesh, split=False)


def device_put(x: torch.Tensor, placement: Placement) -> list[torch.Tensor]:
    """The shards of ``x`` under ``placement``, one per device of
    ``placement.mesh.flat``, each a copy on its device. Across processes
    ``x`` is this process's part of the data axis."""
    mesh = placement.mesh
    if not placement.split:
        return [to_device(x, d) for d in mesh.flat]
    rows = mesh.local_shape[DATA_AXIS]
    if x.shape[0] % rows:
        raise ValueError(f"dim 0 of {x.shape[0]} does not split over the "
                         f"data axis of {rows}")
    chunks = x.chunk(rows)
    return [to_device(chunks[i], d)
            for i, row in enumerate(mesh.devices) for d in row]


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device``: a peer copy across cards,
    a device copy on one."""
    return x.to(device=device, memory_format=torch.contiguous_format,
                copy=True)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Join the multi-host process group (the DCN tier of the JAX
    package): one process per host, each driving its local devices.

    Reads ``OMPC_COORDINATOR`` (``host:port``), ``OMPC_NUM_PROCESSES`` and
    ``OMPC_PROCESS_ID`` where the arguments are not given; a no-op when
    there is no coordinator. ``backend`` defaults to ``nccl`` where a card
    is attached and ``gloo`` on the CPU.
    """
    coordinator = coordinator or os.environ.get("OMPC_COORDINATOR")
    if coordinator is None:
        return
    # `x if x is not None else ...`, NOT `x or ...`: process_id=0 is valid.
    if num_processes is None:
        num_processes = int(os.environ["OMPC_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["OMPC_PROCESS_ID"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
