"""Object-detection output layer — port of
``deeplearning4j_tpu/nn/layers/objdetect.py``: the YOLOv2 loss head
``Yolo2OutputLayer`` with its IoU helpers, and the host-side decode
(``DetectedObject``, ``get_predicted_objects``, ``nms``).

The loss is one function of tensors over the (B, H, W, A, 5+C) volume —
the responsible anchor by shape IoU, the coordinate, confidence (IoU
target, detached) and class terms — with no host read, so a train step
that ends in it is captured whole. Decode and NMS run on the host after
``output()``, as the reference's do.

Layouts (NHWC, as the reference):
  activations: (B, gridH, gridW, A·(5+C))  — A anchors, C classes
  labels:      (B, gridH, gridW, 4+C)      — [x1, y1, x2, y2] in grid
               units + one-hot class
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ... import _dist
from .base import Ctx
from .core import LossLayer

# the anchors of each layer config on each device
_ANCHORS = {}


def box_iou_wh(wh1, wh2):
    """IoU of two boxes sharing a center, given (w, h) each; broadcasts."""
    inter = torch.minimum(wh1[..., 0], wh2[..., 0]) * \
        torch.minimum(wh1[..., 1], wh2[..., 1])
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter
    return inter / torch.clamp(union, min=1e-9)


def box_iou_xyxy(a, b):
    """IoU of boxes in (x1, y1, x2, y2); broadcasts over leading dims."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


@dataclass
class Yolo2OutputLayer(LossLayer):
    """YOLOv2 detection loss head (no params; a loss over the conv
    activations). ``anchors``: (w, h) priors in grid units, one per box.
    Loss = lambda_coord · position + confidence (IoU target) + class
    cross-entropy, each over the cells that hold an object."""

    anchors: Sequence[Tuple[float, float]] = field(
        default_factory=lambda: [(1.0, 1.0)])
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    @property
    def n_anchors(self):
        return len(self.anchors)

    def init(self, gen, input_shape):
        return {}, {}, input_shape

    def _anchors(self, like):
        """The (A, 2) priors on ``like``'s device, made once a device (a
        host-to-card copy inside a captured step would fail; the step's
        first, eager call makes it)."""
        key = (tuple(map(tuple, self.anchors)), like.device)
        t = _ANCHORS.get(key)
        if t is None:
            t = _ANCHORS[key] = torch.tensor(self.anchors,
                                             dtype=torch.float32,
                                             device=like.device)
        return t

    def _split(self, x):
        """(B, H, W, A·(5+C)) → activated xy (sigmoid offsets in the cell),
        wh (exp · anchor, grid units), conf (sigmoid), class softmax, and
        the class logits."""
        b, h, w, ch = x.shape
        a = self.n_anchors
        c = ch // a - 5
        x = x.reshape(b, h, w, a, 5 + c).float()
        xy = torch.sigmoid(x[..., 0:2])
        wh = torch.exp(x[..., 2:4]) * self._anchors(x)
        conf = torch.sigmoid(x[..., 4])
        tcls = x[..., 5:]
        return xy, wh, conf, torch.softmax(tcls, dim=-1), tcls

    def apply(self, params, state, x, ctx: Ctx):
        xy, wh, conf, cls, _ = self._split(x)
        b, h, w, a, c = cls.shape
        out = torch.cat([xy, wh, conf[..., None], cls], dim=-1)
        return out.reshape(b, h, w, a * (5 + c)), state

    def compute_loss(self, pre_activation, labels, mask=None,
                     groups=_dist.NONE):
        """The YOLOv2 loss over the batch's objects; under a parallel
        step's ``groups`` this rank's sums over the global batch's object
        count."""
        group = groups.batch
        xy, wh, conf, cls, tcls = self._split(pre_activation)
        b, h, w, a, c = cls.shape
        labels = labels.float()
        gt_xyxy = labels[..., 0:4]                       # (B, H, W, 4)
        gt_cls = labels[..., 4:]                         # (B, H, W, C)
        obj = (torch.sum(gt_cls, dim=-1) > 0).float()    # (B, H, W)
        gt_wh = torch.stack([gt_xyxy[..., 2] - gt_xyxy[..., 0],
                             gt_xyxy[..., 3] - gt_xyxy[..., 1]], dim=-1)
        gt_center = 0.5 * (gt_xyxy[..., 0:2] + gt_xyxy[..., 2:4])
        gt_off = gt_center - torch.floor(gt_center)
        # responsible anchor: the prior whose shape best matches the box
        anc = self._anchors(pre_activation)
        shape_iou = box_iou_wh(gt_wh[..., None, :], anc)   # (B, H, W, A)
        best = torch.argmax(shape_iou, dim=-1, keepdim=True)
        resp = (best == torch.arange(a, device=best.device)).float() * \
            obj[..., None]
        # predicted boxes in grid units, for the confidence target
        cell_x = torch.arange(w, dtype=torch.float32,
                              device=xy.device)[None, None, :, None]
        cell_y = torch.arange(h, dtype=torch.float32,
                              device=xy.device)[None, :, None, None]
        px = xy[..., 0] + cell_x
        py = xy[..., 1] + cell_y
        pred_xyxy = torch.stack([px - wh[..., 0] / 2, py - wh[..., 1] / 2,
                                 px + wh[..., 0] / 2, py + wh[..., 1] / 2],
                                dim=-1)
        iou = box_iou_xyxy(pred_xyxy, gt_xyxy[..., None, :]).detach()
        n_obj = torch.sum(obj) if group is None else \
            _dist.global_count(torch.sum(obj), group)
        n_obj = torch.clamp(n_obj, min=1.0)
        pos = (torch.sum((xy - gt_off[..., None, :]) ** 2, dim=-1)
               + torch.sum((torch.sqrt(torch.clamp(wh, min=1e-9))
                            - torch.sqrt(torch.clamp(gt_wh[..., None, :],
                                                     min=1e-9))) ** 2,
                           dim=-1))
        pos_loss = self.lambda_coord * torch.sum(pos * resp) / n_obj
        conf_loss = (torch.sum((conf - iou) ** 2 * resp)
                     + self.lambda_no_obj * torch.sum(conf ** 2 * (1.0 - resp))
                     ) / n_obj
        logp = torch.log_softmax(tcls, dim=-1)
        cls_loss = -torch.sum(torch.sum(gt_cls[..., None, :] * logp, dim=-1)
                              * resp) / n_obj
        return pos_loss + conf_loss + cls_loss

    def has_params(self):
        return False


@dataclass
class DetectedObject:
    """One decoded detection (DetectedObject), in grid units."""

    center_x: float
    center_y: float
    width: float
    height: float
    predicted_class: int
    confidence: float
    class_probs: np.ndarray

    @property
    def xyxy(self):
        return (self.center_x - self.width / 2,
                self.center_y - self.height / 2,
                self.center_x + self.width / 2,
                self.center_y + self.height / 2)


def get_predicted_objects(layer: Yolo2OutputLayer, activations,
                          threshold: float = 0.5) -> List[List[DetectedObject]]:
    """YoloUtils.getPredictedObjects: the raw (pre-activation) volume
    decoded into detections per image, on the host."""
    with torch.no_grad():
        xy, wh, conf, cls, _ = layer._split(torch.as_tensor(activations))
    xy, wh, conf, cls = (t.cpu().numpy() for t in (xy, wh, conf, cls))
    out = []
    for bi in range(cls.shape[0]):
        dets = []
        score = conf[bi]                                 # (H, W, A)
        ys, xs, ans = np.nonzero(score > threshold)
        for y, x, an in zip(ys, xs, ans):
            cw, ch_ = wh[bi, y, x, an]
            dets.append(DetectedObject(
                center_x=float(xy[bi, y, x, an, 0] + x),
                center_y=float(xy[bi, y, x, an, 1] + y),
                width=float(cw), height=float(ch_),
                predicted_class=int(np.argmax(cls[bi, y, x, an])),
                confidence=float(score[y, x, an]),
                class_probs=cls[bi, y, x, an]))
        out.append(dets)
    return out


def _iou_np(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def nms(detections: List[DetectedObject], iou_threshold: float = 0.45):
    """Greedy per-class non-max suppression (YoloUtils.nms), best first."""
    kept = []
    by_cls = {}
    for d in detections:
        by_cls.setdefault(d.predicted_class, []).append(d)
    for dets in by_cls.values():
        dets = sorted(dets, key=lambda d: -d.confidence)
        while dets:
            best = dets.pop(0)
            kept.append(best)
            ba = np.asarray(best.xyxy)
            dets = [d for d in dets
                    if _iou_np(ba, np.asarray(d.xyxy)) < iou_threshold]
    return sorted(kept, key=lambda d: -d.confidence)
