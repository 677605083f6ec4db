"""The numbers that decide ``correct``: what the timed path produced against
the plain reference.

Detect rows. Random weights put many scores close together, so two sums
taken in different orders rank anchors differently and NMS keeps other
rows: rows cannot be compared one to one. Each live row the program kept
is instead matched to the reference's anchor that it comes from, the
anchor nearest in box (source pixels) and score together (one pixel
weighs as much as 0.001 of score), and the row is read against that
anchor's box and its score for the row's class:

  box_gap_px   the widest distance (L-infinity, source pixels) of a live
               row's box from its anchor's box; a frame with no live row
               where the reference has some reads as its longer side (an
               answer that never came)
  score_gap    the widest difference of a live row's score from its
               anchor's score for that class

Those two read every row against all the anchors, so they cannot see the
selection: NMS left out, or every frame's rows cut short, reads as well as
the reference. The selection is read by how many rows each side keeps:

  count_gap    |ln((live rows + 1) / (the reference's live rows + 1))|
               over all the frames read together: 0 where both keep as
               many, 1.9 where the program keeps all 300 top-k rows of
               frames on which the reference's NMS keeps 45. Taken frame
               by frame it is no use: a frame on which the reference keeps
               3 rows and the program 1 reads ln 2 under bf16 rounding
               alone, more than the float8 control reads

Which anchors each side keeps is counted too, but not compared: bf16
rounding alone swaps 10-36% of them through near-tied ranks at the top-k
cut and in NMS chains, and the float8 control reads only 2.5x that.

Served tokens: the widest gap by which a served token's logit lies below
the reference's best at that position (``logit_gap``), greedy requests only.
"""
from __future__ import annotations

import math

import torch

SCORE_PER_PX = 1e-3


def detect_gaps(rows, ref_kept, ref_boxes, ref_probs, frame_hw) -> dict:
    """rows [K, 6] (x1, y1, x2, y2, score, class; dead rows zero), the
    reference's kept anchors [K] (-1: none), ref_boxes [N, 4] source-pixel
    xyxy of every anchor, ref_probs [N, nc], the frame's (height, width)
    -> one frame's ``box_gap_px``, ``score_gap``, ``live`` (the program's
    live rows), ``ref_kept`` (anchors the reference kept) and ``kept_diff``
    (anchors kept by one side only)."""
    dev = ref_boxes.device
    rows = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    live = rows[rows[:, 4] > 0]
    ref_set = set(ref_kept[ref_kept >= 0].tolist())
    out = {"live": int(live.shape[0]), "ref_kept": len(ref_set)}
    if live.shape[0] == 0:
        return dict(out, box_gap_px=float(max(frame_hw)) if ref_set else 0.0, score_gap=0.0,
                    kept_diff=len(ref_set))
    cls = live[:, 5].long().clamp(0, ref_probs.shape[1] - 1)
    box_d = (live[:, None, :4] - ref_boxes[None]).abs().amax(-1)          # [R, N]
    score_d = (live[:, 4:5] - ref_probs[:, cls].T).abs()                  # [R, N]
    best = (box_d + score_d / SCORE_PER_PX).argmin(1)
    r = torch.arange(live.shape[0], device=dev)
    prog = best.tolist()
    diff = len(ref_set.symmetric_difference(prog)) + (len(prog) - len(set(prog)))
    return dict(out, box_gap_px=float(box_d[r, best].max()),
                score_gap=float(score_d[r, best].max()), kept_diff=diff)


def count_gap(live: int, ref_kept: int) -> float:
    """|ln((live + 1) / (ref_kept + 1))|: how far the program's count of
    kept rows lies from the reference's."""
    return abs(math.log((live + 1) / (ref_kept + 1)))


def logit_gap(ref_logits, tokens) -> float:
    """ref_logits [T, V] at the positions that produced ``tokens`` [T] ->
    the widest max(logits) - logits[token]."""
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=ref_logits.device)
    chosen = ref_logits.gather(1, tokens[:, None])[:, 0]
    return float((ref_logits.max(1).values - chosen).max())
