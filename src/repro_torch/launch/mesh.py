"""Mesh construction (port of ``src/repro/launch/mesh.py``) on
``torch.distributed.device_mesh.init_device_mesh``.

Defined as functions, never module-level constants: a DeviceMesh needs
an initialised default process group of the mesh's world size (the
dry run's is a fake one, ``launch.dryrun``; the mesh check's a gloo
group of spawned ranks, ``launch.mesh_check``).
"""
from __future__ import annotations


def make_mesh(dims, axes, device_type="cuda"):
    """A DeviceMesh of ``dims`` named ``axes`` over the process group's
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(dims),
                            mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False):
    """((dims), (axis names)) of the production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: (16, 16) = ('data', 'model'), 256 ranks.
    Multi-pod: (2, 16, 16) = ('pod', 'data', 'model'), 512 ranks."""
    return make_mesh(*production_shape(multi_pod=multi_pod),
                     device_type=device_type)


def make_host_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                   device_type="cuda"):
    """A small mesh over the process group's ranks (the tests' 2 x 2 and
    2 x 1 x 2)."""
    if pod:
        return make_mesh((pod, n_data, n_model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


HW = {
    # NVIDIA H100 SXM5 80GB per-card data-sheet constants (at its 700 W
    # limit) for the roofline analysis: dense bf16 tensor-core rate, HBM3
    # rate, NVLink 4 rate per direction, and memory
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "ici_bw_per_link": 450e9,
    "hbm_bytes": 80e9,
}
