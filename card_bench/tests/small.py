"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, driver and comparison, with the configuration's input size,
the batch and the pool made small, more detections an image, and the
device the CPU."""
from __future__ import annotations

import os

from card_bench.harness import ROOT, load_cell, read_json

# class biases 0.75 higher than the cells': at this size the cells' bias
# gives a few detections a batch, under what the comparison judges
SMALL_TRAFFIC = dict(batch=8, pool_images=16, calib_images=4, ref_block=2, check_batches=1,
                     warmup_batches=1, trace_skip=0, trace_batches=1, class_bias=-4.75)


def manifest():
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def small_cell(name: str, seed: int = 1234567, seconds: float = 0.5, trace: bool = False,
               size: int = 320):
    cell = load_cell(manifest(), name, seed, seconds, trace, device="cpu")
    cell.config = {**cell.config, "input_size": size}
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC}
    return cell
