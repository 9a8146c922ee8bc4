"""Host-side image and audio transforms of the data layer.

Counterpart of `avmoe_tpu/data/transforms.py`: jpg decode, resize to the
model's frame size and ImageNet normalization, channels-last numpy. cv2 and
PIL are imported where an image is decoded, never when the module is
imported.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_decode_path_logged = False


def _use_pil_decode() -> bool:
    """AVMOE_PIL_DECODE=1 forces the PIL path: PIL's bicubic resize is the
    original recipe's exact one; cv2's INTER_AREA / INTER_CUBIC is faster
    but differs at the pixel level on a downscale."""
    return os.environ.get("AVMOE_PIL_DECODE", "0") == "1"


def _log_decode_path_once(path_name: str) -> None:
    global _decode_path_logged
    if not _decode_path_logged:
        _decode_path_logged = True
        logging.getLogger(__name__).info(
            "image decode path: %s (AVMOE_PIL_DECODE=1 forces the PIL bicubic resize)",
            path_name)


def load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """Decode, resize and ImageNet-normalize -> (H, W, 3) float32; cv2
    unless AVMOE_PIL_DECODE=1 or cv2 is absent or cannot read the file."""
    if not _use_pil_decode():
        try:
            import cv2

            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            if bgr is not None:
                _log_decode_path_once("cv2 (fast)")
                interp = (cv2.INTER_AREA if bgr.shape[0] > size[1] and bgr.shape[1] > size[0]
                          else cv2.INTER_CUBIC)
                bgr = cv2.resize(bgr, size, interpolation=interp)
                arr = bgr[:, :, ::-1].astype(np.float32) / 255.0
                return (arr - IMAGENET_MEAN) / IMAGENET_STD
        except ImportError:
            pass
    from PIL import Image

    _log_decode_path_once("PIL bicubic")
    with Image.open(path) as im:
        im = im.convert("RGB").resize(size, Image.BICUBIC)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 or float in [0, 1] -> ImageNet-normalized float32."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    return (x / 32767.0).astype(np.float32)


def pad_or_trim_wave(wave: np.ndarray, length: int) -> np.ndarray:
    """Right-pad with zeros or trim to exactly `length` samples."""
    if wave.shape[-1] >= length:
        return wave[..., :length]
    pad = [(0, 0)] * (wave.ndim - 1) + [(0, length - wave.shape[-1])]
    return np.pad(wave, pad)
