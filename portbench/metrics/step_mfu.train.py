"""step_mfu.train: the training window's model FLOPs (6 N T plus
attention's forward and backward over each sequence, ``work.model_flops``)
over (the window's seconds x the bf16 peak), in %.  Layer: steps
(``launch/steps.py`` ``make_train_step``); read by the host clock around
the untraced window."""
from work import model_flops, peaks

LAYER = "steps"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(ctx):
    s = ctx.run.stats
    if not s["steps"]:
        return None
    rows = ctx.mix["microbatches"] * ctx.mix["rows_per_microbatch"]
    flops = model_flops.train_flops(ctx.conf, ctx.mix["seq_len"],
                                    s["steps"] * rows)
    return 100.0 * flops / (s["seconds"] * peaks.PEAK_FLOPS_BF16)
