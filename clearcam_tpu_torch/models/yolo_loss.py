"""YOLO detection fine-tuning loss over torch: task-aligned assignment +
CIoU + BCE, the counterpart of ``clearcam_tpu.models.yolo_loss``.

The objective is the standard anchor-free YOLO one on the decoded head
output (``models.yolov9.forward_raw``: [B, N, 4+nc], xywh boxes in
letterbox pixels and sigmoided class scores), as in the JAX module.

Assignment is TAL (task-aligned): candidates are anchors whose centre falls
inside a GT box; alignment t = score^alpha * IoU^beta; the top-k anchors per
GT; an anchor claimed by several GTs goes to the highest-IoU one. Losses:
BCE against t-normalised soft class targets, and CIoU on the positives.
Shapes are static and masked (padded GT rows carry class -1).

Where the two packages could drift, this module follows JAX's rules:
CIoU's aspect weight and the whole assignment carry no gradient
(``stop_gradient`` there, ``detach``/``no_grad`` here); ``torch.maximum``
and ``torch.minimum`` stand where JAX takes ``jnp.maximum``/``jnp.clip``,
so a tie splits the gradient in halves as JAX's does (``torch.clamp``
would pass all of it); the batch that JAX ``vmap``s is a leading
dimension; ``argmax`` takes the first maximum on both sides, and the k-th
largest alignment is found by value.

One JAX fault is not copied: its BCE clips the class scores at ``1 - EPS``,
which is 1.0 in float32, so once a sigmoid saturates the loss is infinite
and every parameter turns NaN at the next step (the JAX ``finetune`` tool
does so at step 11 of 30 on 1080p images at res 640, batch 8, lr 3e-4).
The port clips at ``P_MAX``, the largest float32 below 1; below it the two
agree.

``make_finetune_step`` is ``optax.chain(clip_by_global_norm(c),
adamw(lr))`` over ``torch.optim.AdamW`` with optax's defaults (betas 0.9
and 0.999, eps 1e-8, weight decay 1e-4, not torch's 1e-2), and optax's
clipping rule: gradients scaled by c / norm only when norm >= c.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as tF
import torch.utils.checkpoint

from . import yolov9

ALPHA, BETA = 1.0, 6.0
TOPK = 10
EPS = 1e-9
# the BCE's upper clip: the largest float32 below 1. The JAX module clips at
# 1 - EPS, which rounds to 1.0 in float32, so a saturated sigmoid there
# gives log(0): an infinite loss and NaN gradients from then on
P_MAX = 1.0 - 2.0 ** -24
WEIGHT_DECAY = 1e-4         # optax.adamw's default


def _xywh_to_xyxy(b):
    return torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)


def _zero(t):
    return t.new_zeros(())


def _ciou(a, b):
    """IoU and CIoU of boxes ``a`` and ``b`` [..., 4] xyxy, broadcast."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    zero = _zero(ax1)
    iw = torch.maximum(zero, torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1))
    ih = torch.maximum(zero, torch.minimum(ay2, by2) - torch.maximum(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter + EPS
    iou = inter / union
    # enclosing box diagonal + centre distance
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + EPS
    rho2 = (((ax1 + ax2) - (bx1 + bx2)) ** 2 + ((ay1 + ay2) - (by1 + by2)) ** 2) / 4
    # aspect-ratio term
    wa, ha = ax2 - ax1, (ay2 - ay1) + EPS
    wb, hb = bx2 - bx1, (by2 - by1) + EPS
    v = (4 / math.pi ** 2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / (1 - iou + v + EPS)
    return iou, iou - rho2 / c2 - alpha.detach() * v


def pairwise_ciou(pred_xyxy, gt_xyxy):
    """[..., N, 4] x [..., M, 4] -> IoU and CIoU [..., N, M]."""
    return _ciou(pred_xyxy[..., :, None, :], gt_xyxy[..., None, :, :])


def elementwise_ciou(a_xyxy, b_xyxy):
    """CIoU of matched box pairs [..., N, 4] x [..., N, 4] -> [..., N]."""
    return _ciou(a_xyxy, b_xyxy)[1]


@torch.no_grad()
def assign(pred, gt_boxes, gt_cls, anchors):
    """TAL assignment; no gradient flows through it.

    pred [..., N, 4+nc] (xywh + probs), gt [..., M, 4] xyxy, gt_cls [..., M]
    (-1 pad), anchors [N, 2] centres (letterbox px); the leading dims are
    the batch (none for one image).
    -> (cls_target [..., N, nc], box_target [..., N, 4] xyxy, fg [..., N] bool)
    """
    pred = pred.detach()
    n, m = pred.shape[-2], gt_boxes.shape[-2]
    nc = pred.shape[-1] - 4
    valid = gt_cls >= 0                                        # [..., M]
    pred_xyxy = _xywh_to_xyxy(pred[..., :4])
    probs = pred[..., 4:]

    iou, _ = pairwise_ciou(pred_xyxy, gt_boxes)                # [..., N, M]
    cls_idx = torch.clamp(gt_cls, 0, nc - 1).long()
    score = torch.gather(probs, -1, cls_idx[..., None, :].expand(*iou.shape))
    align = (score ** ALPHA) * (torch.maximum(iou, _zero(iou)) ** BETA)

    ax, ay = anchors[:, 0:1], anchors[:, 1:2]                  # [N, 1]
    gx1, gy1, gx2, gy2 = (gt_boxes[..., None, :, i] for i in range(4))
    inside = (ax > gx1) & (ax < gx2) & (ay > gy1) & (ay < gy2)     # [..., N, M]
    align = torch.where(inside & valid[..., None, :], align, _zero(align))

    # top-k anchors per GT
    k = min(TOPK, n)
    thresh = torch.sort(align, dim=-2).values[..., n - k, :][..., None, :]   # kth largest
    mask = (align >= torch.clamp(thresh, min=EPS)) & (align > 0)
    # resolve anchors claimed by several GTs: keep the highest-IoU one
    best_gt = torch.argmax(torch.where(mask, iou, torch.full_like(iou, -1.0)), dim=-1)
    fg = mask.any(dim=-1)
    mask = mask & tF.one_hot(best_gt, m).bool()

    # soft class targets: t scaled so max per GT equals max IoU per GT
    t_max = align.amax(dim=-2, keepdim=True)
    iou_max = torch.where(mask, iou, _zero(iou)).amax(dim=-2, keepdim=True)
    norm_align = align * iou_max / torch.clamp(t_max, min=EPS)
    anchor_score = torch.where(mask, norm_align, _zero(norm_align)).amax(dim=-1)

    cls_onehot = tF.one_hot(torch.gather(cls_idx, -1, best_gt), nc).to(pred.dtype)
    cls_target = cls_onehot * anchor_score[..., None]
    box_target = torch.gather(gt_boxes, -2, best_gt[..., None].expand(*best_gt.shape, 4))
    return cls_target, box_target, fg


def detection_loss(params, frames, gt_boxes, gt_cls, *, size="t", box_w=7.5, cls_w=0.5):
    """frames [B,H,W,3] float 0..1 RGB (already letterbox-shaped); GT boxes
    [B,M,4] xyxy in the same pixel space, classes [B,M] (-1 pad).
    -> scalar loss. The forward is ``forward_raw``'s training route, so
    the stem kernel runs on the live weights and gradients reach them."""
    raw = yolov9.forward_raw(params, frames, size, train=True)     # [B,N,4+nc]
    h, w = frames.shape[1:3]
    anchors, strides = yolov9._make_anchors([(h // s, w // s) for s in yolov9.STRIDES])
    anchor_px = torch.from_numpy(anchors * strides[:, None]).to(raw.device)

    cls_t, box_t, fg = assign(raw, gt_boxes, gt_cls, anchor_px)
    probs = torch.minimum(torch.maximum(raw[..., 4:], raw.new_tensor(EPS)),
                          raw.new_tensor(P_MAX))
    bce = -(cls_t * torch.log(probs) + (1 - cls_t) * torch.log(1 - probs))
    denom = torch.clamp(cls_t.sum(dim=(-2, -1)), min=1.0)                # [B]
    cls_loss = bce.sum(dim=(-2, -1)) / denom
    ciou = elementwise_ciou(_xywh_to_xyxy(raw[..., :4]), box_t)
    weight = cls_t.amax(dim=-1) * fg
    box_loss = ((1.0 - ciou) * weight).sum(dim=-1) / denom
    return (cls_w * cls_loss + box_w * box_loss).mean()


class _Optimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr))``:
    ``init(params)`` makes the state, a ``torch.optim.AdamW`` over the
    parameter dict's tensors, updated in place."""

    def __init__(self, lr: float, clip_norm: float):
        self.lr, self.clip_norm = lr, clip_norm

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params.values()), lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=WEIGHT_DECAY)

    def clip(self, grads: list, leaves: list | None = None) -> None:
        """optax's rule, in place: g * c / norm where norm >= c, else g.
        Tensor-parallel slices (``leaves`` marked ``tp_group``) add their
        ranks' squares: one ``all_reduce`` over each group, so every rank
        clips by the norm of the whole gradient."""
        norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        groups = {getattr(p, "tp_group", None) for p in leaves or ()} - {None}
        if groups:
            from ..parallel import comm
            for grp in groups:
                mask = torch.tensor([getattr(p, "tp_group", None) is grp for p in leaves],
                                    device=norms.device)
                part = comm.all_reduce((torch.where(mask, norms, 0.0) ** 2).sum(), grp)
                norms = torch.cat([torch.where(mask, 0.0, norms), part.sqrt()[None]])
        norm = torch.linalg.vector_norm(norms)
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)


def average_over_data(mesh, grads: list, loss):
    """The data-parallel mean, in place: each gradient and the loss summed
    over the mesh's ``data`` group (one ``all_reduce`` each) and divided by
    its size. Equal shards of a loss that is a mean over images give the
    one-device step's gradients. -> the mean loss."""
    from ..parallel import comm
    d = mesh.shape["data"]
    if d == 1:
        return loss
    grp = mesh.group("data")
    for g in grads:
        comm.all_reduce(g, grp).div_(d)
    return comm.all_reduce(loss.clone(), grp) / d


def make_finetune_step(size: str = "t", lr: float = 1e-3, clip_norm: float = 10.0,
                       remat: bool = False, mesh=None):
    """-> (step, opt). ``opt.init(params)`` makes the optimizer state for a
    dict of leaf tensors (requires_grad); ``step(params, opt_state, frames,
    gt_boxes, gt_cls)`` -> (params, opt_state, loss) updates both in place
    and returns them, as the JAX step returns new ones. Global-norm
    clipping keeps the large cold-start cls loss from destabilising AdamW.
    ``remat=True`` wraps the whole loss in ``torch.utils.checkpoint``
    (non-reentrant), as the JAX step wraps it in ``jax.checkpoint``: the
    backward reruns the forward instead of keeping its activations. With
    the whole loss as one segment the rerun rebuilds them all before the
    backward frees any, so the peak memory does not fall.

    ``mesh`` (``parallel.mesh``): each rank passes its data rank's rows and
    its ``shard_params_tp`` params; the gradients are averaged over
    ``data`` before the global-norm clip (whose norm counts the split
    gradients once, over ``model``), so every rank steps on the same
    gradients; the loss returned is the mean over ``data``."""
    opt = _Optimizer(lr, clip_norm)
    loss_fn = functools.partial(detection_loss, size=size)
    if remat:
        loss_fn = functools.partial(torch.utils.checkpoint.checkpoint, loss_fn,
                                    use_reentrant=False)

    def step(params, opt_state, frames, gt_boxes, gt_cls):
        leaves = list(params.values())
        loss = loss_fn(params, frames, gt_boxes, gt_cls)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if mesh is not None:
            loss = average_over_data(mesh, grads, loss)
        opt.clip(grads, leaves if mesh is not None else None)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt_state.step()
        for p in leaves:
            p.grad = None
        return params, opt_state, loss

    return step, opt
