"""Production and host meshes: the port of ``repro.launch.mesh``.

Defined as FUNCTIONS (never module-level constants), so importing this
module starts no process group and touches no device.

JAX is single-controller: one process addresses every device of a mesh.
torch is multi-process: a ``DeviceMesh`` spans the ranks of the current
process group, one process per device, and each process holds its own
blocks. So a mesh over several cards takes one process per card, each
calling these functions (``torchrun``, or ``torch.multiprocessing`` with
``init_process_group`` on a shared store); the production meshes are
built over the 256 or 512 ranks of such a group, or of the "fake" group
the dry run (``launch.dryrun``) makes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the current group's ranks: one pod =
    16 x 16 = 256 devices; two pods = 512.

    Axes: ("data", "model") single-pod; ("pod", "data", "model")
    multi-pod. "model" (TP/EP) stays inside a pod; "pod" x "data" carry
    FSDP/DP. The group must have exactly that many ranks. Its only user
    is the dry run's "fake" group, whose ranks are CPU stand-ins."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """Dev mesh ("data", "model") over the current process group's ranks
    (tests, examples). With no group yet it starts a group of one process
    on an in-memory store (``nccl`` for the card, ``gloo`` for the CPU),
    so one process on one card gets the (1, 1) mesh with no network and
    no launcher. The mesh is on the card unless ``device_type="cpu"``
    asks for the CPU. A ``model_parallel`` that does not divide the
    world size raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world size {n}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
