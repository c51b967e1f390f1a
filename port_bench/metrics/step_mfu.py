"""The whole step's share of the chip's FP32 peak: the FP32 operations the
solves of the traced window needed (:mod:`port_bench.counts`, every kernel
launch's executed iterations, heads included) over the window's seconds
times 67 TFLOP/s, in %. The window is that of the device's activity alone,
where the host runs unslowed, as in an untraced run.

Layer: the whole step. Moves ``solves_per_s``. A later change that takes a
kernel off the path leaves that kernel's roofline silent; this share still
bounds it."""

from port_bench import counts


def read(ctx):
    tr = ctx.device
    if tr is None or not ctx.device_launches or not tr.ops or tr.window_s <= 0:
        return None
    flops = sum(r["flops"]() for r in ctx.device_launches)
    return 100.0 * flops / (tr.window_s * counts.FP32_PEAK)
