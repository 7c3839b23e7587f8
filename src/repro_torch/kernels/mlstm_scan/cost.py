"""The work of one chunkwise mLSTM, forward and backward: (FLOPs, bytes)
from its shapes, for the card's bound (``launch.mesh.bound``) and the step
count (``distributed.flops``)."""
from __future__ import annotations

import torch

# the chunk at which the backward's pairs are counted, whatever chunk a
# route takes, so that every route is held to one yardstick
BWD_CHUNK = 64


def work(B, S, H, Dh, dtype, with_init):
    """(flops, bytes) of one forward: q, k, v, ig, fg (and an initial
    state) read once and h, C, n, m written once.  FLOPs count the least
    work of the function, whatever chunk an evaluation takes: per (b, h), q
    C and the state update (k g)^T v, 4 S Dh^2 at any chunk, plus the
    intra-chunk q k^T and W v over the (query, key) pairs the causal mask
    leaves, 2 S (T + 1) Dh at chunk T, least at T = 1 (the sequential
    form: 4 S Dh)."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    n = B * S * H * Dh
    state = 4 * (B * H * Dh * Dh + B * H * Dh + B * H)
    nbytes = (3 * n * size[dtype] + 4 * n + 2 * 4 * B * S * H
              + state * (2 if with_init else 1))
    return 4.0 * B * H * S * Dh * (Dh + 1), nbytes


def bwd_work(B, S, H, Dh, dtype, chunk=BWD_CHUNK):
    """(flops, bytes) of one backward.  FLOPs: per (b, h) the five state
    products (C's update, C dnum, D's update, D v, D^T k), 10 S Dh^2, and
    the five products over the pairs a chunk of ``chunk`` steps leaves
    under the causal mask, 5 S (chunk + 1) Dh.  Bytes: q, k, v, h, dh, ig,
    fg and the row statistics read once, dq, dk, dv, dig and the row sums
    written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    n = B * S * H * Dh
    nbytes = n * (6 * size + 8) + 4 * B * S * H * 6
    flops = float(B * H) * (10.0 * S * Dh * Dh + 5.0 * S * (chunk + 1) * Dh)
    return flops, nbytes
