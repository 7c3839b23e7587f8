"""The work of one RG-LRU scan, forward and backward: (FLOPs, bytes) from
its shapes, for the card's bound (``launch.mesh.bound``, at the float32
rate: the scan computes in float32 whatever its inputs) and the step count
(``distributed.flops``)."""
from __future__ import annotations

import torch

# operations per (b, t, d) element: two sigmoids (3 each), the rate
# product, exp, the doubling, expm1, negation, sqrt, two products and the
# recurrence's multiply-add (2)
OPS_PER_ELEM = 16
# float32 operations per (b, t, d) element of the backward: the gates
# (two sigmoids, expm1, sqrt: 12), the carry (2), dlog_a (7), dga (4),
# dgx (5), dx (2), three partial sums (3)
BWD_OPS_PER_ELEM = 35


def work(B, S, D, x_dtype, g_dtype, with_h0, fused):
    """(flops, bytes) of one scan: x, ga, gx, lam (the biases b_a and b_i
    on the fused route, and h0) read once, y and h_last written once;
    OPS_PER_ELEM float32 operations per (b, t, d) element."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    n = B * S * D
    nbytes = (n * (size[x_dtype] + 2 * size[g_dtype] + 4) + 4 * D
              + (8 * D if fused else 0)
              + 4 * B * D * (2 if with_h0 else 1))
    return float(OPS_PER_ELEM * n), nbytes


def bwd_work(B, S, D, dtype, fused):
    """(flops, bytes) of one backward: x, ga, gx (``dtype``), the forward's
    y and dy (float32), lam and the biases read once; dx, dga, dgx
    (``dtype``), dlam and the biases' gradients written once;
    BWD_OPS_PER_ELEM float32 operations an element."""
    size = torch.tensor([], dtype=dtype).element_size()
    n = B * S * D
    nbytes = n * (6 * size + 8) + 4 * D * (4 if fused else 2)
    return float(BWD_OPS_PER_ELEM * n), nbytes
