"""The device mesh and the multi-process runtime.

The reference replicates its model per GPU and load-balances work through a
shared channel (src/lib.rs:154-200); ``herro_tpu`` builds a ``data`` mesh (or
a 2-D ``(data, model)`` mesh for tensor parallelism) over the process-local
devices. Here a :class:`Mesh` is that grid of ``torch.device``: row i is data
replica i, column j its model shard j. A device may appear more than once
(every shard on one card), which runs the layout on fewer cards than it
names.

Multi-host runs keep one independent replica pipeline per process: the work
splits upstream (alignment batches are target-partitioned and strided by
process index), so no mesh spans processes. ``torch.distributed`` supplies
only the process index and count, as ``jax.distributed`` does in the
reference (herro_tpu/parallel/mesh.py:23-29).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 2-D grid of devices with the axes ``("data", "model")``."""

    devices: tuple[tuple[torch.device, ...], ...]

    def __post_init__(self):
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError(f"a mesh is a non-empty grid of devices, got {self.devices}")

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.tp}


def make_mesh(devices) -> Mesh:
    """A 1-D data mesh: one replica on each of ``devices``."""
    return Mesh(tuple((torch.device(d),) for d in devices))


def make_mesh_2d(n_data: int, n_model: int, devices) -> Mesh:
    """``n_data`` replicas of ``n_model`` shards over the first
    ``n_data * n_model`` of ``devices``, row-major as the reference's
    ``make_mesh_2d``."""
    devs = [torch.device(d) for d in devices]
    n = n_data * n_model
    if n < 1 or len(devs) < n:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n} devices, have {len(devs)}")
    return Mesh(tuple(tuple(devs[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def parse_devices(spec) -> int | list[int]:
    """'0' -> all local devices (0); '4' -> 4; '0,1,3' -> an index list (the
    reference's -d, src/main.rs:86-92)."""
    spec = str(spec)
    if "," in spec:
        return [int(s) for s in spec.split(",") if s != ""]
    n = int(spec)
    if n < 0:
        raise ValueError(f"--devices {spec}: a count cannot be negative")
    return n


def local_devices(spec, device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices ``--devices spec`` names on this host.

    On the card: '0' is every local card (or, when ``device`` names one,
    ``cuda:N``, that card alone), 'n' the first n, '0,1,3' those indices;
    asking for a card the host lacks raises. With ``device`` 'cpu' the
    count (or the list's length) is the number of CPU replicas, '0' one: the
    port's counterpart of the virtual CPU devices the reference's tests run
    on."""
    dev = torch.device(device)
    n = parse_devices(spec)
    if dev.type == "cpu":
        return [dev] * (len(n) if isinstance(n, list) else max(n, 1))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) to "
            "run on the CPU"
        )
    have = torch.cuda.device_count()
    if isinstance(n, list):
        idx = n
    elif n == 0:
        idx = [dev.index] if dev.index is not None else list(range(have))
    else:
        idx = list(range(n))
    missing = [i for i in idx if not 0 <= i < have]
    if not idx or missing:
        raise ValueError(
            f"--devices {spec}: asks for cards {idx}, this host has {have} "
            f"(cuda:0..cuda:{have - 1})"
        )
    return [torch.device("cuda", i) for i in idx]


def init_distributed(coordinator: str | None, num_processes: int | None,
                     process_id: int | None) -> None:
    """Join the process group (nothing for one process): gloo over TCP at
    ``coordinator`` (host:port), which process 0 serves."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator address host:port")
    if not 0 <= (process_id or 0) < num_processes:
        raise ValueError(f"process id {process_id} is not below {num_processes}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id or 0,
    )


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shutdown_distributed(wait: bool = True) -> None:
    """Leave the group (nothing for one process), after a barrier unless
    ``wait`` is off (a process that failed leaves at once): process 0 serves
    the store the others reach, so none leaves before all are done."""
    if dist.is_available() and dist.is_initialized():
        if wait:
            dist.barrier()
        dist.destroy_process_group()
