"""The card's figures and the local device mesh (PyTorch port of
``repro/launch/mesh.py``).

The reference's figures are a TPU v5e's and its meshes span 256 chips; the
port runs on one NVIDIA H100 (SXM, 80 GB HBM3), or on the ranks of a
``torch.distributed`` process group, one card each.  The rates are NVIDIA's
data sheet's dense peaks (no sparsity), which assume the card's full power
limit of 700 W; a card set below it runs slower under load, and
``chip_smoke.py`` prints the limit of the card it ran on.
"""
from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM data sheet, per card
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_FLOPS_F32 = 67e12            # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80 * 10**9            # 80 GB of HBM3
NVLINK_BW = 450e9                 # B/s each way, to the host's other cards
SMS = 132                         # streaming multiprocessors
SMEM_PER_BLOCK = 232_448          # bytes of shared memory a block can use

# the peak rate of the operations on inputs of each type
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_BF16,
              torch.float32: PEAK_FLOPS_F32}


def bound(work, dtype):
    """(ms, "bytes" or "operations", flops, bytes): the least time the card
    takes for ``work`` = (flops, bytes), the larger of its bytes over the
    memory rate and its operations over the peak rate for ``dtype``."""
    flops, nbytes = work
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def _process_group_device_type(device_type):
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group; call "
                           "torch.distributed.init_process_group first")
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(dp: int, tp: int, multi_pod: bool = False, *,
                         device_type=None):
    """A ``DeviceMesh`` ("data", "model"), or ("pod", "data", "model") of
    2 x dp x tp, over the ranks of the default process group, one card
    each (the reference's production mesh, whose pods are 256 TPU chips;
    here the sizes are the caller's).  Raises unless the mesh covers the
    group's world size exactly.  ``device_type`` defaults to "cuda" on an
    NCCL group and "cpu" on any other."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _process_group_device_type(device_type)
    shape = (2, dp, tp) if multi_pod else (dp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1, *, device_type=None):
    """A ``DeviceMesh`` ("data", "model") of (world // model_axis,
    model_axis) over the ranks of the default process group, one card
    each; ``model_axis`` is clipped to [1, world].  Raises without a
    process group: the caller starts it
    (``torch.distributed.init_process_group``) with its address, world
    size and rank.  ``mesh["data"]`` is its one-dimensional data axis."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _process_group_device_type(device_type)
    n = dist.get_world_size()
    model_axis = max(1, min(model_axis, n))
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_axis}")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_chips(mesh) -> int:
    return mesh.size()
