"""AVS segmentation metrics: mask IoU and the 255-threshold F-measure, and
the predicted masks' PNG files.

Counterpart of `avmoe_tpu/metrics/avs.py`. `save_mask` writes the 8-bit
grayscale PNGs itself (zlib and struct), so it needs no imaging library.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable

import numpy as np
import torch

from avmoe_tpu_torch.parallel.mesh import is_main


def mask_iou(pred_logits: torch.Tensor, target: torch.Tensor, eps: float = 1e-7
             ) -> torch.Tensor:
    """Mean IoU of the thresholded masks over N (H, W) images; an image whose
    ground truth is empty scores the background IoU over all its pixels."""
    pred = (torch.sigmoid(pred_logits) > 0.5).to(torch.int32)
    target = target.to(torch.int32)
    num_pixels = pred.shape[-1] * pred.shape[-2]
    no_obj = target.sum(dim=(1, 2)) == 0
    inter = (pred * target).sum(dim=(1, 2))
    union = torch.maximum(pred, target).sum(dim=(1, 2))
    inter = torch.where(no_obj, ((1 - target) * (1 - pred)).sum(dim=(1, 2)), inter)
    union = torch.where(no_obj, torch.full_like(union, num_pixels), union)
    return (inter / (union + eps)).mean()


def eval_fmeasure(pred_logits: torch.Tensor, gt: torch.Tensor, pr_num: int = 255,
                  beta2: float = 0.3) -> torch.Tensor:
    """The largest F-measure over `pr_num` thresholds of the mean
    precision / recall curve, averaged over the images with a non-empty
    ground truth (N, H, W); one image at a time, so the (pr_num, H, W)
    masks exist for one image only."""
    probs = torch.sigmoid(pred_logits.float())
    gt = gt.float()
    ths = torch.linspace(0.0, 1.0 - 1e-10, pr_num, device=probs.device)
    curve = torch.zeros(pr_num, device=probs.device)
    valid = gt.mean(dim=(1, 2)) > 0.0
    for p, y, ok in zip(probs, gt, valid.tolist()):
        if not ok:
            continue
        yp = (p[None] >= ths[:, None, None]).float()
        tp = (yp * y[None]).sum(dim=(1, 2))
        prec = tp / (yp.sum(dim=(1, 2)) + 1e-20)
        rec = tp / (y.sum() + 1e-20)
        curve += torch.nan_to_num((1 + beta2) * prec * rec / (beta2 * prec + rec))
    return (curve / max(int(valid.sum()), 1)).max()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_gray_png(img: np.ndarray) -> bytes:
    """An (H, W) uint8 array as an 8-bit grayscale PNG: no filter on any row,
    one zlib stream."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter byte 0
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # depth 8, grayscale
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def save_mask(pred_logits: np.ndarray, save_dir: str, names: Iterable[str]) -> None:
    """Binarize the logits of N (H, W) masks at sigmoid > 0.5 and write each
    as `<save_dir>/<name>.png`, 0 or 255 a pixel; on rank 0 only, under a
    process group."""
    if not is_main():
        return
    os.makedirs(save_dir, exist_ok=True)
    masks = (1 / (1 + np.exp(-np.asarray(pred_logits))) > 0.5).astype(np.uint8) * 255
    for m, name in zip(masks, names):
        with open(os.path.join(save_dir, f"{name}.png"), "wb") as f:
            f.write(encode_gray_png(m))
