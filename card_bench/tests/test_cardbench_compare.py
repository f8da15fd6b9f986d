"""The serving comparison on detections made up by hand: one-to-one
matching, the due rule in images under and at the cap, and what each
number reads."""
import math

import torch

from card_bench import compare

CONF, CAP = 0.25, 4


def dets(rows, cap=CAP):
    """rows of (x1, y1, x2, y2, logit, class), best first, one image."""
    n = len(rows)
    boxes = torch.zeros(1, cap, 4)
    logits = torch.full((1, cap), -math.inf)
    classes = torch.full((1, cap), -1, dtype=torch.long)
    for j, (x1, y1, x2, y2, lg, c) in enumerate(rows):
        boxes[0, j] = torch.tensor([x1, y1, x2, y2])
        logits[0, j], classes[0, j] = lg, c
    return {"boxes": boxes, "logits": logits, "scores": torch.sigmoid(logits).nan_to_num(0.0),
            "classes": classes, "count": torch.tensor([n])}


def counts(prog, ref):
    got = compare.serving(prog, ref, CONF, CAP)
    return {k: int(v.sum()) for k, v in got.items() if k != "gaps"}, got["gaps"]


def test_the_same_detections_match_one_to_one():
    ref = dets([(0, 0, 10, 10, 3.0, 1), (20, 20, 30, 30, 2.0, 2)])
    got, gaps = counts(ref, ref)
    assert got == {"due_ref": 2, "missed": 0, "due_prog": 2, "extra": 0}
    assert len(gaps) == 2 and float(gaps.max()) < 1e-5


def test_a_box_kept_twice_is_extra():
    ref = dets([(0, 0, 10, 10, 3.0, 1)])
    prog = dets([(0, 0, 10, 10, 3.0, 1), (0, 0, 10, 11, 2.9, 1)])
    assert counts(prog, ref)[0] == {"due_ref": 1, "missed": 0, "due_prog": 2, "extra": 1}


def test_a_wrong_class_is_missed_and_extra():
    ref = dets([(0, 0, 10, 10, 3.0, 1)])
    prog = dets([(0, 0, 10, 10, 3.0, 2)])
    assert counts(prog, ref)[0] == {"due_ref": 1, "missed": 1, "due_prog": 1, "extra": 1}


def test_near_the_threshold_is_not_due():
    near = math.log((CONF + 0.01) / (1 - CONF - 0.01))
    ref = dets([(0, 0, 10, 10, near, 1)])
    assert counts(dets([]), ref)[0] == {"due_ref": 0, "missed": 0, "due_prog": 0, "extra": 0}


def test_at_the_cap_only_what_clears_the_last_kept_is_due():
    ref = dets([(0, 0, 10, 10, 6.0, 1), (20, 20, 30, 30, 3.5, 1),
                (40, 40, 50, 50, 3.2, 1), (60, 60, 70, 70, 3.0, 1)])
    # 3.0 is the last kept: 6.0 is due, 3.5 and 3.2 are not (margin 1)
    assert counts(dets([]), ref)[0]["due_ref"] == 1


def test_summary_reads_the_shares_and_the_floor():
    ref = dets([(0, 0, 10, 10, 3.0, 1), (20, 20, 30, 30, 2.0, 2)])
    prog = dets([(0, 0, 10, 10, 2.0, 1)])
    s = compare.summary([compare.serving(prog, ref, CONF, CAP)], min_due=1)
    assert s["missed_pct"] == 100.0          # 2 due, under MIN_COMPARED
    assert s["extra_pct"] == 0.0
    assert abs(s["score_gap_p50"] - 1.0) < 1e-5
    assert abs(s["image_error_pct"] - 100.0 / 3) < 1e-9
    many = [compare.serving(prog, ref, CONF, CAP)] * compare.MIN_COMPARED
    assert compare.summary(many)["missed_pct"] == 50.0


def test_verdict_fails_what_is_missing_or_not_finite():
    limits = {"a": {"limit": 1.0}, "b": {"limit": 1.0}}
    assert compare.verdict({"a": 0.5, "b": 1.0}, limits)[0]
    assert not compare.verdict({"a": 0.5}, limits)[0]
    assert not compare.verdict({"a": 0.5, "b": math.inf}, limits)[0]
