"""flash_roofline.train: the flash-attention kernels' least time over their
profiled time in the traced training steps, in %.  Each forward launch
(``flash_fwd_*``) and each backward call (counted by its first pass,
``flash_bwd_dot*``) at the step's shape (rows of a microbatch x seq_len,
causal) takes the larger of its FLOPs over the bf16 peak and its bytes
over HBM's rate (``work.flash``); the time is every ``flash_fwd_*`` and
``flash_bwd_*`` kernel's.  Layer: kernels (``kernels/flash_attention``,
forward and backward)."""
import re

from work import flash, model_flops, peaks

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"
KERNELS = {"forward": re.compile(r"\bflash_fwd_"),
           "backward": re.compile(r"\bflash_bwd_"),
           "backward calls": re.compile(r"\bflash_bwd_dot")}


def read(ctx):
    t_fwd, n_fwd = ctx.trace.matching(KERNELS["forward"])
    t_bwd, _ = ctx.trace.matching(KERNELS["backward"])
    _, n_bwd = ctx.trace.matching(KERNELS["backward calls"])
    if not n_fwd or t_fwd + t_bwd <= 0:
        return None
    s = model_flops.dims(ctx.conf)
    shape = (ctx.mix["rows_per_microbatch"], ctx.mix["seq_len"], s["H"],
             s["KH"], s["Dh"], True)
    least = n_fwd * peaks.least_seconds(*flash.work(*shape)) + \
        n_bwd * peaks.least_seconds(*flash.bwd_work(*shape))
    return 100.0 * least / (t_fwd + t_bwd)
