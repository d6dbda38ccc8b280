"""The control at a size a test run holds: the reference put in the
program's place in float8 (the precision below the configuration's
bfloat16) comes out not correct under each cell's limits, where the
program itself comes out correct. On the card the same comparison runs
at the cells' own sizes (``perfbench/control.py``)."""
import time

import pytest
import torch

from perfbench.control import readings
from perfbench.tests.tiny import cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["internlm2-chat-closed64",
                                  "starcoder2-code-poisson",
                                  "internlm2-train-4k"])
def test_control_fails_where_the_program_passes(name):
    c = cell(name)
    if "check" in c.traffic:       # a sample of some hundreds of tokens
        c.traffic["check"].update(served_tokens=400, max_tokens=20000)
        c.traffic["rate_per_s"] = 15.0
    row = readings(c, 2 ** 31 + 99, 3.0, CPU, time.perf_counter(), "cpu")
    assert row["correct"], row["program"]
    assert all(row["program"][n] <= lim for n, lim in c.limits.items())
    assert any(row["control"][n] > lim for n, lim in c.limits.items()), \
        row["control"]
    if "half_batch" in row:
        assert any(row["half_batch"][n] > lim for n, lim in c.limits.items())
