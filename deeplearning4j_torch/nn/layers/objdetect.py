"""YOLOv2 output layer implementation.

Counterpart of ``deeplearning4j_tpu/nn/layers/objdetect.py`` (reference
``nn/layers/objdetect/Yolo2OutputLayer.java``):

- input [b, gh, gw, 5B + C] (NHWC): B anchor blocks of (x, y, w, h,
  confidence), then C class logits a cell, shared by its anchors;
- labels [b, 4 + C, gh, gw]: the corners (x1, y1, x2, y2) in grid units
  and a one-hot class map; a cell holds an object when its class row is
  not all 0;
- the responsible anchor of a cell is the argmax over B of the IOU of its
  predicted box with the cell's box (the first on a tie), where the cell
  holds an object;
- the loss: lambda_coord x the responsible anchors' (sigmoid(xy) -
  frac(centre))^2 + (sqrt(anchor e^wh) - sqrt(label wh))^2; (confidence -
  IOU)^2 on the responsible anchors, the IOU carrying its gradient;
  lambda_no_obj x confidence^2 on the others; the squared error of the
  class softmax on the cells with an object; the sum over the batch
  divided by b.

Autograd takes the place of the reference's hand-written backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LayerImpl, implements

__all__ = ["Yolo2OutputImpl"]


@implements("Yolo2OutputLayer")
class Yolo2OutputImpl(LayerImpl):
    def _anchors(self, device):
        return torch.tensor(self.conf.boxes, dtype=torch.float32, device=device)   # [B, 2]

    def _split(self, x):
        """[b, gh, gw, 5B + C] -> boxes [b, gh, gw, B, 5], class logits
        [b, gh, gw, C]."""
        B = len(self.conf.boxes)
        b, gh, gw, _ = x.shape
        return x[..., :5 * B].reshape(b, gh, gw, B, 5), x[..., 5 * B:]

    def forward(self, x, mask=None, ctx=None):
        """Sigmoid on xy and the confidence, anchor x exp on wh, the class
        softmax a cell (reference ``activate``)."""
        boxes, cls_logits = self._split(x)
        b, gh, gw, B, _ = boxes.shape
        wh = torch.exp(boxes[..., 2:4]) * self._anchors(x.device)
        out = torch.cat([torch.sigmoid(boxes[..., 0:2]), wh,
                         torch.sigmoid(boxes[..., 4:5])], dim=-1)
        return torch.cat([out.reshape(b, gh, gw, 5 * B), torch.softmax(cls_logits, -1)], dim=-1)

    def loss_on(self, x, labels, mask=None, train=False, gen=None):
        c = self.conf
        anchors = self._anchors(x.device)
        boxes, cls_logits = self._split(x)
        b, gh, gw, B, _ = boxes.shape
        labels = labels.permute(0, 2, 3, 1)
        bbox, cls_label = labels[..., :4], labels[..., 4:]
        obj = (cls_label.sum(-1, keepdim=True) > 0).to(x.dtype)              # [b, gh, gw, 1]
        gt_wh = torch.stack([bbox[..., 2] - bbox[..., 0], bbox[..., 3] - bbox[..., 1]], -1)
        gt_cxy = torch.stack([0.5 * (bbox[..., 0] + bbox[..., 2]),
                              0.5 * (bbox[..., 1] + bbox[..., 3])], -1)
        cell_x = torch.arange(gw, dtype=torch.float32, device=x.device)[None, None, :, None]
        cell_y = torch.arange(gh, dtype=torch.float32, device=x.device)[None, :, None, None]
        p_xy = torch.sigmoid(boxes[..., 0:2])                                # within the cell
        p_cx, p_cy = p_xy[..., 0] + cell_x, p_xy[..., 1] + cell_y
        # a wide clip for numerical safety only
        p_wh = torch.exp(torch.clamp(boxes[..., 2:4], -20, 20)) * anchors
        p_conf = torch.sigmoid(boxes[..., 4])

        # IOU of each predicted box with its cell's box
        ix1 = torch.maximum(p_cx - 0.5 * p_wh[..., 0], bbox[..., None, 0])
        iy1 = torch.maximum(p_cy - 0.5 * p_wh[..., 1], bbox[..., None, 1])
        ix2 = torch.minimum(p_cx + 0.5 * p_wh[..., 0], bbox[..., None, 2])
        iy2 = torch.minimum(p_cy + 0.5 * p_wh[..., 1], bbox[..., None, 3])
        zero = torch.zeros((), dtype=ix1.dtype, device=x.device)
        inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1, zero)
        area_p = p_wh[..., 0] * p_wh[..., 1]
        area_g = (gt_wh[..., 0] * gt_wh[..., 1])[..., None]
        iou = inter / (area_p + area_g - inter + 1e-12)                      # [b, gh, gw, B]

        resp = F.one_hot(iou.argmax(-1), B).to(x.dtype) * obj               # [b, gh, gw, B]
        gt_xy = gt_cxy - torch.floor(gt_cxy)
        d_xy = ((p_xy - gt_xy[..., None, :]) ** 2).sum(-1)
        d_wh = ((torch.sqrt(p_wh + 1e-12)
                 - torch.sqrt(torch.maximum(gt_wh, zero)[..., None, :] + 1e-12)) ** 2).sum(-1)
        coord = (resp * (d_xy + d_wh)).sum()
        conf_obj = (resp * (p_conf - iou) ** 2).sum()
        conf_noobj = ((1.0 - resp) * p_conf ** 2).sum()
        cls = (obj * (torch.softmax(cls_logits, -1) - cls_label) ** 2).sum()
        return (c.lambda_coord * coord + conf_obj + c.lambda_no_obj * conf_noobj + cls) / b
