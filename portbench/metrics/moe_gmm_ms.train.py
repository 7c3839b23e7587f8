"""moe_gmm_ms.train: the expert-FFN kernels' profiled time a traced
training step, forward (``gmm_kernel``, ``gmm_wmma_kernel``,
``gmm_wgmma``) and backward (``gmm_bwd_*``), in ms.  A time and not a
roofline share: the rows the routing keeps are known only inside the
program.  Layer: kernels (``kernels/moe_gmm``, forward and backward)."""
import re

LAYER = "kernels"
UNIT = "ms"
MOVES = "train_tokens_per_s"
KERNELS = {"forward": re.compile(r"\bgmm_(kernel|wmma_kernel|wgmma)\b"),
           "backward": re.compile(r"\bgmm_bwd_")}


def read(ctx):
    t_f, n_f = ctx.trace.matching(KERNELS["forward"])
    t_b, n_b = ctx.trace.matching(KERNELS["backward"])
    if not n_f:
        return None
    return 1e3 * (t_f + t_b) / ctx.run.traced_info["steps"]
