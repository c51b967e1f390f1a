"""ADMM iterations the kernel executed per closed-loop solve (scenario and
step; the heads' presolves left out), from the iterations the launch
reports for each row.

Layer: the ADMM solver. Moves ``solves_per_s``."""


def read(ctx):
    recs = [r for r in ctx.launches if r["kernel"] == "admm" and not r["head"]]
    rows = sum(r["rows"] for r in recs)
    if rows == 0:
        return None
    return sum(float(r["iters"].double().sum()) for r in recs) / rows
