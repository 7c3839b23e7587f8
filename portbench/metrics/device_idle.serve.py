"""device_idle.serve: the share of the traced serving rounds in which no
operation ran on the card, in %.  Layer: device (H100)."""

LAYER = "device"
UNIT = "%"
MOVES = "request_ms_p95"


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
