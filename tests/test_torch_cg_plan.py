"""The CG step kernel's hardware launch (``kernels.cg_plan``) against torch's
virtual one (``kernels.cg_config``), on the CPU.

The step kernel (csrc/cg_ops.cu cg_iter_kernel) runs an iteration's three
stages in one launch split by grid-wide barriers, so its grid must be
resident: a hardware CTA carries ``per`` of torch's virtual CTAs, one
halving tree each, and every CTA forms the grid's sums itself.  The sums
must keep the bits of torch's CUDA sum (``test_torch_cuda.reduce_model``,
which tests/test_torch_cuda.py holds to ``torch.sum`` on the card): here
``test_torch_cuda.plan_model``, the hardware launch's order, gives
reduce_model's bits at every launch shape, tails included, with one or
two virtual CTAs to a hardware CTA, evenly dealt or not; and each plan
is resident on an H100 (132 SMs of 2,048 threads, 65,536 registers and 228
KB of shared memory; the kernel is built for 64 registers a thread).
Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops import kernels
from test_torch_cuda import plan_model, reduce_model

torch.set_num_threads(1)

# the launch shapes of test_torch_cg_device's order test (single elements
# below 128, loads of 4 with and without a tail, one CTA, several, the
# most), the categorical tables, and the card tests' largest
SIZES = [1, 39, 127, 128, 259, 1027, 16000, 32000, 5000 * 32 + 3, 640003,
         3000001, 6400000, 9600001]
H100_SM_SMEM = 233472  # bytes of shared memory an SM gives its CTAs
H100_CTA_RESERVED = 1024  # bytes the card keeps for each CTA


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(1).view(torch.int32)


def _products(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return a * b


@pytest.mark.parametrize("n", SIZES)
def test_hardware_launch_keeps_torch_sum_bits(n):
    x = _products(n, n)
    got, plan = plan_model(x)
    want = reduce_model(x)
    assert plan.grid * plan.per >= plan.cfg.ctas
    assert torch.equal(_bits(got.view(1)), _bits(want.view(1))), n


@pytest.mark.parametrize("n", [3000001, 4000003])
def test_uneven_hardware_ctas_keep_the_bits(n):
    """Past 264 virtual CTAs and not a multiple of them (367 and 489: the
    last hardware CTA carries one virtual CTA, the others two)."""
    x = _products(n, 1)
    plan = kernels.cg_plan(n)
    assert plan.per == 2 and plan.grid * plan.per == plan.cfg.ctas + 1
    got, _ = plan_model(x, plan)
    assert torch.equal(_bits(got.view(1)), _bits(reduce_model(x).view(1)))


def test_model_order_is_not_any_order():
    """The model tells orders apart: 1e8, 1 and -1e8 in one virtual
    thread's successive loads lose the 1, in three threads keep it."""
    n = 12288  # one CTA of 512 threads, 6 loads of 4 each
    span = 4 * kernels.cg_config(n).threads
    for pos, want in (((0, 4, 8), 1.0), ((0, span, 2 * span), 0.0)):
        x = torch.zeros(n)
        x[pos[0]], x[pos[1]], x[pos[2]] = 1e8, 1.0, -1e8
        assert plan_model(x)[0].item() == want == reduce_model(x).item()


@pytest.mark.parametrize("n", SIZES)
def test_plan_is_resident_on_an_h100(n):
    plan = kernels.cg_plan(n)
    cfg = plan.cfg
    nt = cfg.threads
    assert cfg == kernels.cg_config(n)
    assert plan.grid * plan.per >= cfg.ctas > (plan.grid - 1) * plan.per
    by_smem = H100_SM_SMEM // (plan.smem + H100_CTA_RESERVED)
    per_sm = min(2048 // nt, 65536 // (nt * kernels.CG_STEP_REGS), by_smem)
    assert plan.grid <= kernels.H100_SMS * per_sm
    assert plan.smem + H100_CTA_RESERVED <= kernels.H100_CTA_SMEM
    assert 0 <= plan.cache <= plan.loads
    assert plan.smem == 8 * plan.per * nt + 16 * plan.per * plan.cache * nt
    if cfg.ctas > 1:
        # two CTAs of 512 an SM, as few as hold torch's virtual CTAs
        assert nt == 512 and plan.per_sm == 2 and by_smem >= 2
        assert plan.per == -(-cfg.ctas // (2 * kernels.H100_SMS))
    else:
        assert plan.grid == plan.per == 1
    if n in (6400000, 32000, 16000):
        # the MF u side and the categorical tables keep all of V on chip
        assert plan.cache == plan.loads > 0
