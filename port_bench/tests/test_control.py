"""The check's control on a card: the reference with TF32 on, put in the
program's place, fails the cell's limits (one video, one seed, the cell's
own sizes). Skips where there is no card: TF32 exists only there."""

import pytest

from port_bench.control import control_readings
from port_bench.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_tf32_control_fails_the_limits(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    limits = spec.workload(cell)["limits"]
    got = control_readings(cell, 2 ** 31 + 5, videos=1)
    assert any(got[k] > lim for k, lim in limits.items()), got
