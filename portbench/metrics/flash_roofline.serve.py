"""flash_roofline.serve: the flash-attention forward's least time over its
profiled time in the traced serving rounds, in %.  The least time is what
the requests need: for each request its own prompt, unpadded (one causal
sequence, ``work.flash``), once a layer; the time is every
``flash_fwd_*`` kernel's, padding included.  Layer: kernels
(``kernels/flash_attention``, forward)."""
import re

from work import flash, model_flops, peaks

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_tokens_per_s"
KERNELS = {"forward": re.compile(r"\bflash_fwd_")}


def read(ctx):
    t, n = ctx.trace.matching(KERNELS["forward"])
    if not n or t <= 0:
        return None
    s = model_flops.dims(ctx.conf)
    least = s["L"] * sum(
        peaks.least_seconds(*flash.work(1, p, s["H"], s["KH"], s["Dh"], True))
        for lens in ctx.run.traced_info["prompt_lens"] for p in lens)
    return 100.0 * least / t
