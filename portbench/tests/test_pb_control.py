"""The control — the plain reference computed in bfloat16, put in the
program's place — comes out not correct: it fails at least one of the
cell's limits. Here at a small size on the CPU; with the card, at the
cell's own size."""

import pytest
import torch

from portbench import control
from portbench import run as R
from portbench.tests.test_pb_faults import small


@pytest.mark.parametrize("workload", ["water100k.view", "water1m.evaluate"])
@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_control_fails_small(workload, seed):
    torch.set_num_threads(4)
    files = small(workload)
    values = control.control_values(files, seed, "cpu")
    assert any(v > files["limits"][k] for k, v in values.items()), values


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", ["water100k.view", "water1m.evaluate"])
def test_control_fails_at_the_cells_size(workload, cuda):
    files = R.cell_files(workload)
    values = control.control_values(files, 2**31 + 101, cuda)
    assert any(v > files["limits"][k] for k, v in values.items()), values
