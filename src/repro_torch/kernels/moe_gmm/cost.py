"""The work of one grouped expert-FFN call, forward and backward: (FLOPs,
bytes) from its shapes, for the card's bound (``launch.mesh.bound``) and
the step count (``distributed.flops``)."""
from __future__ import annotations

import torch


def work(E, C, d, f, gated, dtype):
    """(flops, bytes) of one expert FFN over E buckets of C rows: 2*E*C*d*f
    FLOPs per product (three with a gate, two without); xe, the weights and
    y once each (not the h workspace, which an ideal kernel keeps on
    chip)."""
    n_up = 2 if gated else 1
    flops = 2.0 * E * C * d * f * (n_up + 1)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (2 * E * C * d + (n_up + 1) * E * d * f)
    return flops, nbytes


def bwd_work(n_live, E, d, f, gated, dtype):
    """(flops, bytes) of one expert FFN backward over ``n_live`` live rows:
    two products per forward product (six with a gate: dh, dw2, the two
    input gradients and the two up-projections' weight gradients); xe, dy
    and dxe over the live rows, the weights read and their gradients
    written once.  The function's least work: the kernel
    (csrc/moe_gmm_bwd.cu) also recomputes a1 and a3 (two more products)
    and moves h, da1 and da3 through a workspace."""
    n_up = 2 if gated else 1
    flops = 2 * (n_up + 1) * 2.0 * n_live * d * f
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (3 * n_live * d + 2 * (n_up + 1) * E * d * f)
    return flops, nbytes
