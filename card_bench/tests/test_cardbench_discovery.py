"""The harness finds every cell's configuration, traffic, driver, limits
and per-layer readers by name, and a cell is added by files and an
entry alone."""
import json
import os
import shutil

from card_bench.harness import ROOT, load_cell, read_json
from card_bench.run import applies, execute, load_reader
from card_bench.tests.small import SMALL_TRAFFIC, manifest


def test_every_cell_and_metric_resolves():
    m = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in m["workloads"]:
        cell = load_cell(m, w["name"], 1, 1.0, False)
        assert os.path.exists(os.path.join(ROOT, "card_bench", "drivers",
                                           cell.traffic["driver"] + ".py"))
        assert cell.limits, w["name"]
        assert cell.spec.input_size == 640
    for metric in m["per_layer"]:
        assert load_reader(metric["name"]) is not None, metric["name"]
    for metric in m["per_layer"] + m["end_to_end"]:
        assert all(w in {c["name"] for c in m["workloads"]} for w in metric.get("workloads", []))


def test_a_cell_is_added_by_files_and_an_entry(tmp_path):
    """A new traffic mix (data), its limits, a new per-layer reader and a
    BENCHMARK.json entry under a copy of the benchmark's folder: the run
    finds them all, and the new metric is in the traced run's line."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "card_bench"), root / "card_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    m = manifest()
    base = "n_serve_bs128"
    src = next(w for w in m["workloads"] if w["name"] == base)
    traffic = read_json(os.path.join(ROOT, "card_bench", "traffic", src["traffic"] + ".json"))
    (root / "card_bench" / "traffic" / "added_mix.json").write_text(
        json.dumps({**traffic, **SMALL_TRAFFIC}))
    shutil.copy(os.path.join(ROOT, "card_bench", "limits", base + ".json"),
                root / "card_bench" / "limits" / "n_added.json")
    (root / "card_bench" / "metrics" / "added_window_items.py").write_text(
        '"""Items the window completed."""\n\n\ndef read(ctx):\n'
        '    return float(ctx.window["items"])\n')
    m["workloads"].append({"name": "n_added", "config": "yolo11n", "traffic": "added_mix",
                           "chips": 1, "why": "added by files alone"})
    m["per_layer"].append({"name": "added_window_items", "unit": "img", "better": "higher",
                           "source": "program_counter", "layer": "host staging",
                           "moves": "serve_img_per_s",
                           "workloads": ["n_added"]})
    for c in m["configs"]:
        shutil.copy(os.path.join(ROOT, c["file"]), root / c["file"])
    cell = load_cell(m, "n_added", 7, 0.3, True, root=str(root), device="cpu")
    cell.config = {**cell.config, "input_size": 320}
    assert applies(m["per_layer"][-1], "n_added")
    out = execute(cell, m, device_check=False)
    assert out["metrics"]["added_window_items"]["value"] > 0
    assert set(out["compared"]) == set(cell.limits)
