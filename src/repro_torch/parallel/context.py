"""Ambient mesh context for the expert-parallel and sequence-parallel
layers (the port of `repro.parallel.context`).

The launcher (`launch/dryrun.py`) sets the active mesh here so model code
deep inside the layer loop (`models/moe.py::moe_forward_ep`,
`models/transformer.py::_sp_constraint`) can read it without threading the
mesh through every call signature.  The mesh is the port's own
`launch/mesh.py::Mesh`, with the `DeviceMesh` of its process group
behind it where one exists; the running per-device program's view of it
is `parallel/spmd.py::current()`.
"""
from __future__ import annotations

from contextlib import contextmanager

_CURRENT = None  # Optional[launch.mesh.Mesh]


def set_current_mesh(mesh) -> None:
    global _CURRENT
    _CURRENT = mesh


def get_current_mesh():
    return _CURRENT


@contextmanager
def mesh_context(mesh):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev
