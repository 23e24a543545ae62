"""The controls, through the cell's own run: the program comes out as
correct by the cell's limits, and the reference in the program's place at
the precision below the configuration's (``calibrate.py``'s
``control_tf32``) as not correct, at each cell's own size on three seeds.
Marked ``cuda``; on the GPU machine:

    python -m pytest ocffm_bench/tests/test_bench_control.py -m cuda -q

On the CPU the same readings run at a tiny size, as a rehearsal of the
hooks they plant.
"""

import pytest
import torch

from ocffm_bench import calibrate
from ocffm_bench.tests.common import tiny_context

CELLS = ["kkbox-ffm-k64.train-skew", "kkbox-ffm-k64.rank-b1024",
         "kkbox-mf-k32.train-uniform"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_on_the_card(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    prog = calibrate.reading(calibrate.context(workload, seed), "program")
    assert prog["correct"], prog["numbers"]
    ctl = calibrate.reading(calibrate.context(workload, seed), "control_tf32")
    assert not ctl["correct"], ctl["numbers"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("variant", ["program", "control_tf32",
                                     "fault_half_positives"])
def test_readings_rehearse_on_the_cpu(workload, variant):
    ctx = tiny_context(workload)
    if variant not in calibrate.VARIANTS[ctx.traffic["driver"]]:
        pytest.skip(f"{variant} is no reading of a ranking cell")
    out = calibrate.reading(ctx, variant)
    assert out["numbers"] and out["seed"] == ctx.seed
    if variant == "program":
        assert out["correct"], out["numbers"]
    if variant == "fault_half_positives":
        assert not out["correct"], out["numbers"]
