"""Production mesh construction.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the "pod" axis
carries data parallelism across the inter-pod links, which is why cross-pod
traffic is restricted to gradient all-reduce (compressible, see
``distributed.collectives``).

The port of ``repro.launch.mesh`` on ``init_device_mesh``, with the
reference's shapes and axis names.  The caller owns the process group:
``torch.distributed`` must be initialised with the mesh's world size
before either function is called (the dry run starts a fake group of that
size).  Defined as functions: importing this module touches no device.
"""

from __future__ import annotations


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cuda"):
    """1-device mesh with the production axis names."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
