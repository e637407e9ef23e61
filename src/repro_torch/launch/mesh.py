"""Meshes (the port of `repro.launch.mesh`).

`Mesh` is a small frozen record: the axes in order with their sizes, the
devices behind them (or `None` for a mesh that exists only as shapes, which
`ShardingRules` reads), and the `torch.distributed` `DeviceMesh` over the
ranks of a process group, which the per-device program of a mesh of more
than one device communicates over (`parallel/spmd.py`).

* `make_host_mesh(model_parallel, device)` spans the ranks of the
  initialised default process group, `(world // model_parallel,
  model_parallel)`: NCCL on the card, one card a rank, `gloo` on the CPU.
  With no group it is today's `(1, 1)` mesh of the one device, with no
  `DeviceMesh`; a group of one rank gives the same mesh with its
  `DeviceMesh`, whose collectives are the identity.
* `make_production_mesh` gives the reference's shapes and axis names with
  no devices behind them.  `fake_production_mesh` builds the same mesh
  behind PyTorch's fake process group of 256 or 512 ranks, in this one
  process, for a capture of the per-device program only (`launch/
  dryrun.py`): its collectives move nothing, and `shard_step` refuses to
  run a step on it.  The fake group is destroyed when its context ends.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    device_mesh: Optional[object] = field(default=None, compare=False)
    fake: bool = False          # ranks of a fake process group: capture only

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")
        dm = self.device_mesh
        if dm is not None and (tuple(dm.mesh.shape) != self.axis_sizes or
                               tuple(dm.mesh_dim_names) != self.axis_names):
            raise ValueError(f"DeviceMesh {dm} is not the {self.shape} mesh")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order (`jax.sharding.Mesh.
        shape`)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def device(self) -> torch.device:
        """This rank's device: the one device of a single-device mesh, or
        the device of this process's rank of a mesh over a process
        group."""
        if self.devices is None:
            raise RuntimeError(f"a {self.axis_sizes} mesh with no devices "
                               f"has no device")
        if len(self.devices) == 1:
            return self.devices[0]
        if self.device_mesh is None:
            raise RuntimeError(f"a {self.axis_sizes} mesh with devices "
                               f"{self.devices} has no single device")
        import torch.distributed as dist
        return self.devices[dist.get_rank()]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    axes, shape = PRODUCTION[multi_pod]
    return Mesh(axes, shape)


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False, device="cpu"):
    """The production mesh behind a fake process group of its 256 (512)
    ranks (`fake_mesh`)."""
    axes, shape = PRODUCTION[multi_pod]
    with fake_mesh(axes, shape, device) as mesh:
        yield mesh


@contextlib.contextmanager
def fake_mesh(axes: Tuple[str, ...], shape: Tuple[int, ...], device="cpu"):
    """A mesh behind a fake process group of its ranks in this process,
    this process rank 0, for the length of the context: for a capture of
    rank 0's per-device program only.  `device` is the device type the
    program is captured for; nothing is allocated there."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already "
                           "initialised in this process")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        kind = torch.device(device).type
        dm = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
        yield Mesh(tuple(axes), tuple(shape), (torch.device(kind),) * n, dm,
                   fake=True)
    finally:
        dist.destroy_process_group()


def make_host_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """Mesh over the ranks of the default process group, one device a rank
    (rank r on CUDA device r modulo the devices present), or, with no
    group, over the one device of `device`'s type (`device="cpu"` for the
    tests)."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass "
                           "device='cpu' to build a CPU mesh")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: no mesh over {kind!r} devices")
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel {model_parallel} does not "
                             f"divide the 1 {kind} device (no process "
                             f"group is initialised)")
        one = torch.device("cuda", torch.cuda.current_device()) \
            if kind == "cuda" else torch.device("cpu")
        return Mesh(("data", "model"), (1, 1), (one,))
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} rank(s) of the process group")
    if kind == "cuda":
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", r % count) for r in range(n))
        torch.cuda.set_device(devices[dist.get_rank()])
    else:
        devices = (torch.device("cpu"),) * n
    shape = (n // model_parallel, model_parallel)
    dm = init_device_mesh(kind, shape, mesh_dim_names=("data", "model"))
    return Mesh(("data", "model"), shape, devices, dm)
