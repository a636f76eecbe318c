"""The control, the port with its bfloat16 policy switched on, comes out
not correct; the program itself passes. On the CPU at a size a test run
holds; on the card (``-m cuda``) at each one-card cell's own size."""
import pytest
import torch

from portbench.calibrate import readings
from portbench.run import load_spec
from portbench.tests.tiny import load

SIZES = {"ilsvrc2012_val_epoch": dict(classes=100, per_class=50),
         "criteo_dac_epoch": dict(rows=200_000, update_rows=50_000)}


def limits(spec):
    return {k: float(v) for k, v in spec["config"]["limits"].items() if k != "why"}


def gaps(spec, seed, control, device):
    out, attempted, failed = readings(spec["config"], spec["traffic"], seed, 2, control, device)
    assert attempted == 2
    return out


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_a_limit_and_the_program_passes_on_the_cpu(workload):
    spec = load(workload, False, **SIZES[workload])
    for seed in (11, 12, 13):
        program = gaps(spec, seed, False, torch.device("cpu"))
        control = gaps(spec, seed, True, torch.device("cpu"))
        assert all(program[k] <= v for k, v in limits(spec).items()), program
        assert any(control[k] > v for k, v in limits(spec).items()), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_a_limit_at_the_cells_size_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = load_spec(workload, traced=False)
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        control = gaps(spec, seed, True, torch.device("cuda", 0))
        assert any(control[k] > v for k, v in limits(spec).items()), control
