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


def make_local_mesh():
    """A one-dimensional ``DeviceMesh`` ("data") over the ranks of the
    default process group, one card each.  Raises without a process group:
    the caller starts it (``torch.distributed.init_process_group``) with
    its address, world size and rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_local_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def mesh_chips(mesh) -> int:
    return mesh.size()
