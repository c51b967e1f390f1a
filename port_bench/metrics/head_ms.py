"""Device milliseconds of an episode's head: the draw of its scenarios and
the program's head (for the linear family the compaction sort and the
presolve, ``LinearMPC.presolve_batch_carry``).

Layer: the episode head. Moves ``solves_per_s``: the head is in the window
and solves nothing that is counted."""


def read(ctx):
    if not ctx.trace.ops or ctx.episodes == 0:
        return None
    return 1e3 * ctx.trace.device_s("head") / ctx.episodes
