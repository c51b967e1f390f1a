"""The frozen operation counts against a hand count at a small size."""

import torch

from port_bench import counts
from port_bench.systems.linear_mpc import Program


def test_admm_flops_equal_a_hand_count():
    # n = 2, m = 3, K = 5: an iteration 2·25 + 12·5 = 110; a chunk 2·2·5
    # + 4·3·2 + 2·4 + 10·5 = 102; a solve 2·3·2 = 12
    assert counts.admm_flops(2, 3, iters=5, checks=2, solves=1) == 5 * 110 + 2 * 102 + 12
    # the headline's K = 80: 2·6400 + 960 = 13,760 an iteration
    assert counts.admm_flops(20, 60, iters=1, checks=0, solves=0) == 13760


def test_launch_record_counts_executed_chunks():
    n, m, rows = 2, 3, 3
    args = [torch.zeros(1)] * 9 + [torch.zeros(rows, n), torch.zeros(rows, m)] + [torch.zeros(1)] * 3
    ni = torch.tensor([8.0, 44.0, 80.0])
    out = (torch.zeros(rows, n), torch.zeros(rows, m), torch.zeros(rows, m), ni)
    rec = Program.launch_record(args, {"chunk_lens": [8, 36, 36]}, out)
    # the rows ran 1, 2 and 3 chunks
    assert rec["flops"]() == counts.admm_flops(n, m, iters=132, checks=6, solves=3)
    assert rec["bytes"] == 4 * (9 + rows * (n + m) + 3 + rows * (n + 2 * m + 1))
    assert rec["rows"] == rows and rec["kernel"] == "admm"


def test_bound_takes_the_larger_time():
    t, by = counts.bound_s(67e12, 1.0)
    assert by == "operations" and abs(t - 1.0) < 1e-12
    t, by = counts.bound_s(1.0, 3.35e12)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
