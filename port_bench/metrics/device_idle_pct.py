"""Share of the traced window in which no operation ran on the device, from
the trace of the device's activity alone (the host runs unslowed there, as
in an untraced run).

Layer: the device. Moves ``solves_per_s``: idle time is time no solve runs."""


def read(ctx):
    tr = ctx.device
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
