"""The ADMM solve's share of its roofline: the least time the chip could
take for the FP32 operations its executed iterations need and the bytes of
its operands and results (:mod:`port_bench.counts`), over the device time of
every operation launched inside the ``solve`` span (the kernel and whatever
the solve entry runs beside it), in %.

Layer: the K1 ADMM kernel. Moves ``solves_per_s``."""

from port_bench import counts


def read(ctx):
    recs = [r for r in ctx.launches if r["kernel"] == "admm"]
    seconds = ctx.trace.device_s("solve")
    if not recs or seconds <= 0:
        return None
    return 100.0 * sum(counts.bound_s(r["flops"](), r["bytes"])[0] for r in recs) / seconds
