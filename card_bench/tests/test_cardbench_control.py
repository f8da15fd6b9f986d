"""The control reads not correct under each cell's limits: the program's
own path one precision below bf16 (int8 W8A8, switched on by
`Detector.quantize`). At a size the CPU holds here; on a card, at the
cell's own size on three seeds, beside the program, which reads
correct."""
import pytest
import torch

from card_bench.compare import verdict
from card_bench.harness import load_cell
from card_bench.sweep import readings
from card_bench.tests.small import manifest, small_cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")
    return "cuda"


def test_control_is_not_correct():
    cell = small_cell("n_serve_bs128")
    got = readings(cell, control=True, window_s=0.3)
    assert verdict(got["control"], cell.limits)[0] is False, got["control"]


@pytest.mark.parametrize("name", ["x_serve_bs128", "n_serve_bs128"])
def test_control_fails_and_program_passes_at_the_cells_size(cuda, name):
    for seed in (991, 992, 993):
        cell = load_cell(manifest(), name, seed, 2.0, False)
        got = readings(cell, control=True)
        assert verdict(got["program"], cell.limits)[0], (seed, got["program"])
        assert not verdict(got["control"], cell.limits)[0], (seed, got["control"])
