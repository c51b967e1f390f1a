"""Device milliseconds per step that the policy spends outside its solve
entry: building the step's QP vectors and shifting the warm start.

Layer: the policy wrapper. Moves ``step_ms_p95``."""


def read(ctx):
    if not ctx.trace.ops or ctx.steps == 0:
        return None
    return 1e3 * ctx.trace.device_s("policy", exclude="solve") / ctx.steps
