"""Device operations (kernels, copies, fills) launched per closed-loop step,
outside the episode head.

Layer: the loop, ``control/batch_loop.py::simulate_batch`` and what it calls
each step. Moves ``step_ms_p95``: each launch costs host enqueue time."""


def read(ctx):
    if not ctx.trace.ops or ctx.steps == 0:
        return None
    return ctx.trace.count("episode", exclude="head") / ctx.steps
