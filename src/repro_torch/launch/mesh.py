"""Meshes (the port of `repro.launch.mesh`).

PyTorch has no mesh object of its own short of `torch.distributed`'s, and
the port needs none of its communication yet, so `Mesh` is a small frozen
record: the axes in order with their sizes, and the devices behind them,
or `None` for a mesh that exists only as shapes (the production meshes,
which the dry run prices by their specs; `launch/dryrun.py`).

`make_production_mesh` gives the reference's shapes and axis names.
`make_host_mesh` spans the devices present: the CUDA devices unless the
caller asks for the CPU, one on one card, so `(1, 1)`.  Nothing here starts
`torch.distributed`: with one device there is nothing to communicate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")

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
        """The one device of a single-device mesh."""
        if self.devices is None or len(self.devices) != 1:
            raise RuntimeError(f"a {self.axis_sizes} mesh with devices "
                               f"{self.devices} has no single device")
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """Mesh over whatever devices of `device`'s type exist: every CUDA
    device, or the one CPU when the caller asks for it (the tests)."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "device='cpu' to build a CPU mesh")
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    elif kind == "cpu":
        devices = (torch.device("cpu"),)
    else:
        raise ValueError(f"make_host_mesh: no mesh over {kind!r} devices")
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} {kind} device(s)")
    return Mesh(("data", "model"), (n // model_parallel, model_parallel),
                devices)
