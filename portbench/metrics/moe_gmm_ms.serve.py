"""moe_gmm_ms.serve: the expert-FFN forward kernels' profiled time in the
traced serving rounds per 1000 tokens the rounds served (prompt and
generated, padding not counted), in ms/ktok.  Layer: kernels
(``kernels/moe_gmm``, forward)."""
import re

LAYER = "kernels"
UNIT = "ms/ktok"
MOVES = "serve_tokens_per_s"
KERNELS = {"forward": re.compile(r"\bgmm_(kernel|wmma_kernel|wgmma)\b")}


def read(ctx):
    t, n = ctx.trace.matching(KERNELS["forward"])
    if not n:
        return None
    return 1e3 * t / (ctx.run.traced_info["tokens"] / 1000.0)
