"""Meshes of the port: ``torch.distributed`` device meshes whose dim names
are the plan's axes, each with the cost model's view of the same shape
(``core.h100_mesh_spec``), so a plan is searched for the mesh it runs on.
The counterpart of ``repro.launch.mesh`` and of the meshes the
reference's commands build (``launch/train.py``: world x 1;
``launch/serve.py::serve_mesh``).

Nothing here touches the process group when imported; the commands call
:func:`init_distributed` first.  Under ``torchrun`` (``WORLD_SIZE`` > 1)
it joins the group through ``env://``, or through the URL in
``REPRO_TORCH_INIT_METHOD`` (``file:///...``, as the tests rendezvous).
"""

from __future__ import annotations

import os

import torch

from repro_torch.core.device import h100_mesh_spec


def init_distributed(device: torch.device) -> tuple[int, int]:
    """Join the process group when launched with ``WORLD_SIZE`` > 1:
    ``nccl`` on the card (``LOCAL_RANK`` picks the GPU), ``gloo`` on the
    CPU.  Returns (rank, world size); (0, 1) without a group."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    if not dist.is_initialized():
        rank = int(os.environ["RANK"])
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=os.environ.get("REPRO_TORCH_INIT_METHOD", "env://"),
            rank=rank, world_size=world)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the process group, dims named
    ``axes`` (a subsequence of ``pod``, ``data``, ``model``, after a
    pipeline plan's ``stage`` axis where it has one)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_smoke_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh (one device by default)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def train_mesh_spec(n_dev: int):
    """The cost model's train mesh, which the plan is searched for: every
    device on ``data`` (the reference's ``launch/train.py``: world x 1;
    a staged search factors its stages out of it itself)."""
    return h100_mesh_spec(1, n_dev, 1)


def train_mesh(n_dev: int, device_type: str = "cuda", stages=None):
    """The train mesh: every device on ``data``, as
    :func:`train_mesh_spec`.  A pipeline-staged plan's ``stages`` (a
    ``StageAssignment``) factor the stage axis out of the devices where
    its ``S`` divides them: ``(S, n_dev // S, 1)`` named
    ``(stages.mesh_axis, "data", "model")``, over which the stack's unit
    dim is split; otherwise there is no stage axis and the stack stays
    replicated, as in the reference."""
    if stages is not None and stages.num_stages > 1 \
            and n_dev % stages.num_stages == 0:
        S = stages.num_stages
        return make_mesh((S, n_dev // S, 1),
                         (stages.mesh_axis, "data", "model"), device_type)
    return make_mesh((n_dev, 1), ("data", "model"), device_type)


def serve_mesh(n_dev: int, device_type: str = "cuda"):
    """(mesh, spec) for serving: two on ``model`` when there are at least
    four devices and an even count, the rest on ``data`` (the reference's
    ``serve_mesh``): the decode phase shards heads / d_ff over model while
    batch rides data."""
    data, model = ((n_dev // 2, 2) if (n_dev >= 4 and n_dev % 2 == 0)
                   else (n_dev, 1))
    return (make_mesh((data, model), ("data", "model"), device_type),
            h100_mesh_spec(1, data, model))
