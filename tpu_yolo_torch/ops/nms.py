"""Batched, fixed-shape non-max suppression (counterpart of
`tpu_yolo/ops/nms.py`).

  1. Candidate ranking: every (anchor, class) pair is a candidate
     (multi-label), or each anchor's argmax class (single-label). The
     top K by score, ties to the lower flat index a*nc + c (the order
     of `lax.top_k`), come from a stable descending sort.
  2. Suppression: the exact sorted-greedy keep mask over the K
     candidates (ops/nms_cuda.py: the hand-written kernel on CUDA, its
     plain version on the CPU).
  3. Compaction: the first `max_det` kept candidates in score order, as
     padded (B, max_det) tensors + a validity mask.

Prefix property: suppression flows only from higher- to lower-ranked
candidates, so the K-budget output is an exact prefix of the output with
every candidate ranked. `envelope=True` also returns each image's count
of above-conf candidates, so a caller can tell when the two differ
(more than K above conf and fewer than max_det kept).

`ranking="approx"` is accepted for the JAX package's serving knob and
ranks exactly: the approximate ranking is TPU-only there too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpu_yolo_torch.ops.anchors import device_anchors
from tpu_yolo_torch.ops.boxes import dfl_decode, xywh_to_xyxy
from tpu_yolo_torch.ops.nms_cuda import MAX_K, greedy_keep
from tpu_yolo_torch.utils import telemetry


def _top_k(x, k: int):
    """Top k along the last axis, descending, ties to the lower index, in
    the float total order of `lax.top_k` (+0 above -0, NaN at the ends):
    a stable sort of int32 keys that order as the floats do."""
    bits = x.float().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _check_ranking(ranking: str):
    if ranking not in ("exact", "approx"):
        raise ValueError(f"ranking must be 'exact' or 'approx': {ranking!r}")


def _rank_candidates_pregated(scores3, k: int):
    """Top-K (score, anchor, class) over a (B, A, nc) score tensor through
    a per-anchor pre-gate: rank anchors by their max class score (ties to
    the lower anchor), keep the top min(A, K) in ascending anchor order,
    and rank their candidates. If (a, c) is among the global top-K
    candidates, anchor a is among the top-K anchors, and the local flat
    order is order-isomorphic to the global one, so the selection equals
    the flat ranking over (B, A*nc) bit for bit (the JAX package's
    theorem); with A <= K the gate keeps every anchor and is that
    ranking."""
    b, a, nc = scores3.shape
    ka = min(a, k)
    _, aidx = _top_k(scores3.amax(-1), ka)
    aidx = aidx.sort(-1).values                                # (B, ka) asc
    rows = torch.gather(scores3, 1, aidx[..., None].expand(b, ka, nc))
    scores, local = _top_k(rows.reshape(b, ka * nc), k)
    anchor_idx = torch.gather(aidx, 1, local // nc)
    return scores, anchor_idx, local % nc


def _rank_candidates_singlelabel(scores3, k: int):
    """One candidate per anchor — its argmax class (lowest class on ties)
    — ranked by that class's score."""
    top, aidx = _top_k(scores3.amax(-1), k)
    cls_idx = torch.gather(scores3.argmax(-1), 1, aidx)
    return top, aidx, cls_idx


def _budget(max_nms: int, a: int, nc: int, multi_label: bool) -> int:
    return min(max_nms, a * nc if multi_label else a, MAX_K)


def _rank(scores3, k: int, multi_label: bool):
    """The top-K candidates of a (B, A, nc) score tensor -> (scores,
    anchor_idx, cls_idx), each (B, K), score-descending."""
    if multi_label:
        return _rank_candidates_pregated(scores3, k)
    return _rank_candidates_singlelabel(scores3, k)


def batched_nms(preds, conf_thres: float = 0.001, iou_thres: float = 0.65,
                max_det: int = 300, max_nms: int = 2048,
                ranking: str = "exact", multi_label: bool = True,
                envelope: bool = False):
    """NMS over decoded predictions (B, A, 4+nc): pixel xywh boxes +
    per-class scores.

    Returns dict of boxes (B, max_det, 4) xyxy, scores (B, max_det),
    classes (B, max_det) int32 (-1 when empty), valid (B, max_det) bool,
    count (B,) int32; with envelope=True also n_above_conf (B,) int32 and
    candidate_budget () int32."""
    _check_ranking(ranking)
    b, a, no = preds.shape
    nc = no - 4
    k = _budget(max_nms, a, nc, multi_label)
    boxes_xywh, scores_all = preds[..., :4], preds[..., 4:]
    top_scores, anchor_idx, cls_idx = _rank(scores_all, k, multi_label)

    cand = torch.gather(boxes_xywh, 1, anchor_idx[..., None].expand(b, k, 4))
    res = _suppress(xywh_to_xyxy(cand), top_scores, cls_idx,
                    conf_thres=conf_thres, iou_thres=iou_thres,
                    max_det=max_det)
    if envelope:
        pop = scores_all if multi_label else scores_all.amax(-1)
        res["n_above_conf"] = (pop > conf_thres).reshape(b, -1).sum(-1).int()
        res["candidate_budget"] = torch.tensor(k, dtype=torch.int32,
                                               device=preds.device)
    return res


def nms_from_raw(raw_maps, cfg, input_hw, conf_thres: float = 0.001,
                 iou_thres: float = 0.65, max_det: int = 300,
                 max_nms: int = 2048, ranking: str = "exact",
                 multi_label: bool = True, envelope: bool = False):
    """Fused decode + NMS from the raw per-level head maps (the inference
    tail of `YOLO.forward_nms`); the same output as
    batched_nms(decode_predictions(raw)).

      * candidates are ranked on the raw class logits: sigmoid is strictly
        increasing, so the top K by logit are the top K by score; sigmoid
        runs on the K winners only. The logits are ranked in their own
        dtype: bf16 -> f32 is a monotone injection, ties included;
      * boxes are DFL-decoded per level for all anchors, then gathered
        per candidate."""
    _check_ranking(ranking)
    with telemetry.span("layer.serve.nms"):
        b = raw_maps[0].shape[0]
        nc = cfg.num_classes
        reg4 = 4 * cfg.reg_max
        a = sum(m.shape[1] * m.shape[2] for m in raw_maps)
        k = _budget(max_nms, a, nc, multi_label)
        with telemetry.span("layer.serve.nms.rank"):
            # (B, A, nc) class logits, anchor-major, levels in order
            logits = torch.cat([m[..., reg4:].reshape(b, -1, nc) for m in raw_maps], 1)
            top_logits, anchor_idx, cls_idx = _rank(logits, k, multi_label)
            top_scores = torch.sigmoid(top_logits.float())

        with telemetry.span("layer.serve.nms.decode"):
            anchors, stride_t = device_anchors(tuple(input_hw), tuple(cfg.strides),
                                               logits.device)
            boxes, off = [], 0
            for m in raw_maps:
                al = m.shape[1] * m.shape[2]
                d = m[..., :reg4].reshape(b, al, reg4)
                boxes.append(dfl_decode(d, anchors[off:off + al], cfg.reg_max,
                                        xywh=False) * stride_t[off:off + al])
                off += al
            boxes = torch.cat(boxes, 1)                              # (B, A, 4) f32
            cand = torch.gather(boxes, 1, anchor_idx[..., None].expand(b, k, 4))

        res = _suppress(cand, top_scores, cls_idx, conf_thres=conf_thres,
                        iou_thres=iou_thres, max_det=max_det)
        if envelope:
            # above-conf population, counted on the logits against the
            # sigmoid preimage log(c/(1-c)) (eval's certificate; in no
            # sub-span, the serving path asks for none)
            c = min(max(conf_thres, 1e-12), 1.0 - 1e-12)
            thr = torch.tensor(math.log(c / (1.0 - c)), dtype=torch.float32,
                               device=logits.device)
            pop = logits if multi_label else logits.amax(-1)
            res["n_above_conf"] = (pop.float() > thr).reshape(b, -1).sum(-1).int()
            res["candidate_budget"] = torch.tensor(k, dtype=torch.int32,
                                                   device=logits.device)
    return res


def nms_to_numpy(result, image_index: int) -> np.ndarray:
    """One image's detections of a batched NMS result (tensors on any
    device, or arrays) as a dense (N, 6) float32 array [x1, y1, x2, y2,
    score, cls], the reference's per-image output."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    n = int(result["count"][image_index])
    out = np.zeros((n, 6), dtype=np.float32)
    out[:, :4] = host(result["boxes"][image_index][:n])
    out[:, 4] = host(result["scores"][image_index][:n])
    out[:, 5] = host(result["classes"][image_index][:n])
    return out


def _suppress(cand_boxes, top_scores, cls_idx, *, conf_thres, iou_thres,
              max_det):
    """Greedy keep over score-descending xyxy candidates (B, K, 4), then
    compaction of the kept rows to the front, in score order. While
    tracing is on it counts the keep's slots and what filled them
    (utils/telemetry.py: nms.images, .slots, .live, .budget_full, .kept,
    .capped)."""
    with telemetry.span("layer.serve.nms.keep"):
        # nan_to_num: a non-finite candidate (diverged weights, corrupt input)
        # would otherwise poison the IoUs of its image
        cand_boxes = torch.nan_to_num(cand_boxes.float(), nan=0.0, posinf=0.0,
                                      neginf=0.0).contiguous()
        top_scores = torch.nan_to_num(top_scores.float(), nan=0.0, posinf=0.0,
                                      neginf=0.0)
        valid = (top_scores > conf_thres).contiguous()
        cls_idx = cls_idx.to(torch.int32).contiguous()
        keep = greedy_keep(cand_boxes, cls_idx, valid, iou_thres)

    with telemetry.span("layer.serve.nms.compact"):
        b, k = keep.shape
        cum = keep.cumsum(1)
        # kept row n goes to slot n-1; every other row to a dump slot max_det
        slot = torch.where(keep & (cum <= max_det), cum - 1, max_det)
        payload = torch.cat([cand_boxes, top_scores[..., None],
                             cls_idx.float()[..., None]], -1)      # (B, K, 6)
        out = torch.zeros(b, max_det + 1, 6, device=payload.device)
        out.scatter_(1, slot[..., None].expand(*slot.shape, 6), payload)
        out = out[:, :max_det]
        slots = torch.arange(1, max_det + 1, device=keep.device)
        out_valid = slots[None, :] <= cum[:, -1:]
        count = out_valid.sum(1).int()
        res = {"boxes": out[..., :4], "scores": out[..., 4],
               "classes": torch.where(out_valid, out[..., 5].int(), -1),
               "valid": out_valid, "count": count}
        if telemetry.on():
            telemetry.add("nms.images", b)
            telemetry.add("nms.slots", b * k)
            # summed when read: slot max_det is filled iff count == max_det
            telemetry.add(("nms.live", "nms.budget_full", "nms.kept", "nms.capped"),
                          lambda: torch.stack([valid.sum(), valid[:, -1].sum(),
                                               out_valid.sum(), out_valid[:, -1].sum()]))
    return res
