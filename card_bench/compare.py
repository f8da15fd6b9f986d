"""The numbers that decide `correct` in a serving cell, worked out from
the detections the program returned and those the reference made from
the same images.

Matching: in each image the program's detections, best score first,
each take the one reference detection of their class not yet taken with
the highest IoU at 0.5 or more (one to one, as mAP matches), so a box
kept twice finds one partner.

Due: a detection the other side has to have. In an image where the
reference keeps fewer than `max_det`, every detection whose score clears
the threshold by MARGIN (logit >= logit(conf + MARGIN)). Where the cap
cuts, which detections make it turns on near-equal scores that rounding
reorders, so there the logit has to clear the reference's last kept one
by CAP_MARGIN besides. The rule is the same for both sides.

  missed_pct      of the reference's due detections, the share that no
                  detection of the program took; 100 where the compared
                  batches hold fewer than MIN_COMPARED due detections of
                  the reference, too few to judge;
  extra_pct       of the program's due detections, the share that took
                  none of the reference's: boxes kept twice, boxes the
                  reference does not have, a wrong class;
  score_gap_p90   over the matched pairs, the 90th percentile of the gap
                  between the two logits (program's from its score,
                  both clipped at ±LOGIT_CLIP, where float32's sigmoid
                  reaches 0 or 1): scores in the wrong units or off;
  image_error_pct in the one image where it is widest, among those with
                  at least MIN_DUE due detections on the two sides
                  together, (missed + extra) / (the two sides' due):
                  one image's answer altered or left out reads near 100.
"""
from __future__ import annotations

import math

import torch

from card_bench.reference.detect import iou

LOGIT_CLIP = 13.8     # logit(1 - 1e-6)
MARGIN = 0.05
CAP_MARGIN = 1.0
MIN_DUE = 25
MIN_COMPARED = 200


def _logit(scores):
    return torch.logit(scores.double().clamp(1e-7, 1 - 1e-7)).float()


def serving(prog: dict, ref: dict, conf: float, max_det: int) -> dict:
    """One batch. prog: {"boxes" (B, D, 4), "scores" (B, D), "classes"
    (B, D), "count" (B,)}; ref the same with "logits" (B, D), on one
    device. Returns per image (CPU tensors) the due and unmatched counts
    of each side, and the matched pairs' logit gaps."""
    dev = ref["boxes"].device
    b, d_r = ref["scores"].shape
    d_p = prog["scores"].shape[1]
    n_p, n_r = prog["count"].to(dev).long(), ref["count"].long()
    pv = torch.arange(d_p, device=dev)[None] < n_p[:, None]
    rv = torch.arange(d_r, device=dev)[None] < n_r[:, None]
    p_logit = torch.where(pv, _logit(prog["scores"].to(dev)), -torch.inf)
    order = torch.sort(p_logit, dim=1, descending=True, stable=True).indices
    p_logit, pv = p_logit.gather(1, order), pv.gather(1, order)
    pb = prog["boxes"].to(dev).float().gather(1, order[..., None].expand(b, d_p, 4))
    pc = prog["classes"].to(dev).long().gather(1, order)
    r_logit = torch.where(rv, ref["logits"], -torch.inf)

    overlap = iou(pb, ref["boxes"].float())
    ok = ((overlap >= 0.5) & (pc[:, :, None] == ref["classes"][:, None, :].long())
          & pv[:, :, None] & rv[:, None, :])
    taken = torch.zeros(b, d_r, dtype=torch.bool, device=dev)
    partner = torch.full((b, d_p), -1, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    for j in range(int(n_p.max()) if b else 0):
        best, at = torch.where(ok[:, j] & ~taken, overlap[:, j], -1.0).max(1)
        hit = best >= 0.5
        partner[:, j] = torch.where(hit, at, -1)
        taken[rows, at] |= hit

    last = r_logit.gather(1, (n_r - 1).clamp(min=0)[:, None])[:, 0]
    cut = torch.full((b,), math.log((conf + MARGIN) / (1 - conf - MARGIN)), device=dev)
    cut = torch.where(n_r >= max_det, torch.maximum(cut, last + CAP_MARGIN), cut)
    due_r = rv & (r_logit >= cut[:, None])
    due_p = pv & (p_logit >= cut[:, None])
    matched = partner >= 0
    pair_ref = r_logit.gather(1, partner.clamp(min=0))
    gaps = (p_logit.clamp(-LOGIT_CLIP, LOGIT_CLIP) - pair_ref.clamp(-LOGIT_CLIP, LOGIT_CLIP)).abs()
    return {"due_ref": due_r.sum(1).cpu(), "missed": (due_r & ~taken).sum(1).cpu(),
            "due_prog": due_p.sum(1).cpu(), "extra": (due_p & ~matched).sum(1).cpu(),
            "gaps": gaps[matched].cpu()}


def summary(parts: list, min_due: int = MIN_DUE) -> dict:
    """The compared numbers over the batches' `serving` parts."""
    cat = {k: torch.cat([p[k] for p in parts]) if parts else torch.zeros(0) for k in
           ("due_ref", "missed", "due_prog", "extra", "gaps")}
    due_r, due_p = int(cat["due_ref"].sum()), int(cat["due_prog"].sum())
    gaps = cat["gaps"].double()
    due = cat["due_ref"] + cat["due_prog"]
    err = (cat["missed"] + cat["extra"]).double() / due.clamp(min=1)
    judged = due >= min_due
    return {"missed_pct": (100.0 * int(cat["missed"].sum()) / due_r
                           if due_r >= MIN_COMPARED else 100.0),
            "extra_pct": 100.0 * int(cat["extra"].sum()) / max(due_p, 1),
            "score_gap_p50": float(gaps.quantile(0.5)) if len(gaps) else math.inf,
            "score_gap_p90": float(gaps.quantile(0.9)) if len(gaps) else math.inf,
            "image_error_pct": 100.0 * float(err[judged].max()) if judged.any() else 0.0,
            "reference_due": due_r, "program_due": due_p, "images_judged": int(judged.sum())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have
    a limit; a number missing or not finite is not correct."""
    compared, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= spec["limit"]
        ok = ok and good
        compared[name] = {"value": v, "limit": spec["limit"]}
    return ok, compared
