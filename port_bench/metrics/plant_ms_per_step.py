"""Device milliseconds per step of the plant's update.

Layer: the plant. Moves ``step_ms_p95``."""


def read(ctx):
    if not ctx.trace.ops or ctx.steps == 0:
        return None
    return 1e3 * ctx.trace.device_s("plant") / ctx.steps
