"""A run with the timed path broken underneath reads `correct` false:
the harness's look for a card skipped, the rest of the run driven on the
CPU at a small size, with each fault a serving cell can have planted in
the program (half of the batch left out, an answer altered where it is
produced)."""
import pytest

import tpu_yolo_torch.serve as serve
from card_bench.run import execute
from card_bench.sweep import FAULTS
from card_bench.tests.small import manifest, small_cell


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_serving_fault_is_not_correct(monkeypatch, fault):
    detect = serve.Detector.detect_batch
    monkeypatch.setattr(serve.Detector, "detect_batch",
                        lambda self, images: FAULTS[fault](detect(self, images)))
    out = execute(small_cell("n_serve_bs128"), manifest(), device_check=False)
    assert out["correct"] is False, out["compared"]


def test_the_same_run_unbroken_is_correct():
    """The runs above differ from this one by their fault alone."""
    out = execute(small_cell("n_serve_bs128"), manifest(), device_check=False)
    assert out["correct"] is True, out["compared"]
