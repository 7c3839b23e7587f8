"""step_mfu.serve: the model FLOPs of the requests the serving window
completed (2 N T over prompt and fed-back tokens plus each request's own
attention, unpadded, ``work.model_flops``) over (the window's seconds x
the bf16 peak), in %.  Layer: serving loop (``launch/serve.py``
``serve``); read by the host clock around the untraced window."""
from work import model_flops, peaks

LAYER = "serving loop"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(ctx):
    s = ctx.run.stats
    if not s["completed"]:
        return None
    flops = sum(model_flops.serve_flops(ctx.conf, p, n)
                for p, n in s["completed"])
    return 100.0 * flops / (s["seconds"] * peaks.PEAK_FLOPS_BF16)
