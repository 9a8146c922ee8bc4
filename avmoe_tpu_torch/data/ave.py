"""AVE dataset: frames, raw waveform and one-hot segment labels.

Counterpart of `avmoe_tpu/data/ave.py`, reading the same on-disk layout:

  * `Annotations.txt`: '&'-separated category&video_id&quality&start&end rows
  * `labels.h5` ('avadataset', (N, 10, 29) one-hot per clip) and
    `{split}_order.h5` ('order', the split's clip indices)
  * `frames/<vid>/0001.jpg` .. `0010.jpg`: one frame per segment
  * `wave/<vid>.npy`: the clip's waveform, (10, L) or flat

`SyntheticAVEDataset` makes random data of the same schema, seeded per
index. Both yield dicts of numpy arrays, bit-identical to the JAX package's
for the same index and seed. h5py is imported by `AVEDataset` only.

`LAVisHView` wraps either for the LAVisH baseline (MMIL_Net_v2): its
'wave' becomes 'audio_spec', the segments' normalized Kaldi-fbank images
(`wave_to_lavish_spec`), made on the host in float64 by the loader's
workers.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from avmoe_tpu_torch.audio.kaldi import fbank
from avmoe_tpu_torch.data.transforms import load_image, pad_or_trim_wave


class AVEDataset:
    """Map-style dataset of one split, yielding dicts of numpy arrays."""

    NUM_CLASSES = 28
    NUM_SEGMENTS = 10
    AUDIO_LEN = 32_000
    IMG_SIZE = 192

    def __init__(self, root: str, split: str = "train", img_size: int = IMG_SIZE):
        import h5py

        self.root = root
        self.img_size = img_size
        with h5py.File(os.path.join(root, "labels.h5"), "r") as f:
            self.labels = np.asarray(f["avadataset"])
        with h5py.File(os.path.join(root, f"{split}_order.h5"), "r") as f:
            self.order = np.asarray(f["order"]).astype(np.int64)
        self.video_ids: List[str] = []
        with open(os.path.join(root, "Annotations.txt")) as f:
            next(f)  # header
            for line in f:
                parts = line.strip().split("&")
                if len(parts) >= 2:
                    self.video_ids.append(parts[1])

    def __len__(self) -> int:
        return len(self.order)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        clip = int(self.order[idx])
        vid = self.video_ids[clip]
        size = (self.img_size, self.img_size)
        frames = np.stack([
            load_image(os.path.join(self.root, "frames", vid, f"{t + 1:04d}.jpg"), size)
            for t in range(self.NUM_SEGMENTS)])
        wave = np.load(os.path.join(self.root, "wave", f"{vid}.npy"))
        wave = pad_or_trim_wave(wave.reshape(self.NUM_SEGMENTS, -1).astype(np.float32),
                                self.AUDIO_LEN)
        return {"wave": wave, "images": frames.astype(np.float32),
                "labels": self.labels[clip].astype(np.float32)}


class SyntheticAVEDataset:
    """Random AVE-shaped data of the same schema, deterministic per index.

    With learnable=True the class is in the signal: event segments carry a
    class-specific tone in the waveform and a class-coloured square in the
    frames, so a working train loop lifts the accuracy above chance."""

    def __init__(self, length: int = 64, num_segments: int = 10, audio_len: int = 32_000,
                 img_size: int = 192, num_classes: int = 28, seed: int = 0,
                 learnable: bool = False, sample_rate: int = 32_000):
        self.length = length
        self.num_segments = num_segments
        self.audio_len = audio_len
        self.img_size = img_size
        self.num_classes = num_classes
        self.seed = seed
        self.learnable = learnable
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100_003 + idx)
        T, C = self.num_segments, self.num_classes
        labels = np.zeros((T, C + 1), dtype=np.float32)
        cls = rng.randint(0, C)
        is_event = rng.rand(T) < 0.7
        for t in range(T):
            labels[t, cls if is_event[t] else C] = 1.0
        wave = rng.randn(T, self.audio_len).astype(np.float32) * 0.1
        images = rng.rand(T, self.img_size, self.img_size, 3).astype(np.float32)
        if self.learnable:
            freq = 200.0 * (cls + 1)
            tone = 0.5 * np.sin(
                2 * np.pi * freq * np.arange(self.audio_len) / self.sample_rate
            ).astype(np.float32)
            sz = max(self.img_size // 4, 2)
            r = (cls % 7) / 7.0
            g = ((cls // 7) % 4) / 4.0
            for t in range(T):
                if is_event[t]:
                    wave[t] += tone
                    images[t, :sz, :sz] = (r, g, 1.0)
        return {"wave": wave, "images": images, "labels": labels}


# ----------------------------------------------------- LAVisH (MMIL_Net_v2)

# AVE's fbank normalization statistics for the 192-bin Swin input
LAVISH_NORM_MEAN = -4.984795570373535
LAVISH_NORM_STD = 3.7079780101776123


def wave_to_lavish_spec(wave: np.ndarray, *, sample_rate: int = 16_000, size: int = 192,
                        frame_shift_ms: float = 5.2, norm_mean: float = LAVISH_NORM_MEAN,
                        norm_std: float = LAVISH_NORM_STD) -> np.ndarray:
    """(T, L) waveform segments -> (T, size, size) float32 fbank images: all
    T segments through one float64 Kaldi fbank call (`size` mel bins, a
    5.2-ms shift, hanning window), (x - mean) / (2 std), zero-padded or cut
    to `size` frames."""
    fb = fbank(torch.from_numpy(np.asarray(wave, np.float64).reshape(wave.shape[0], -1)),
               sample_frequency=sample_rate, frame_shift_ms=frame_shift_ms,
               num_mel_bins=size, window_type="hanning").numpy()
    fb = (fb - norm_mean) / (norm_std * 2.0)
    out = np.zeros((wave.shape[0], size, size), np.float32)
    n = min(size, fb.shape[1])
    out[:, :n] = fb[:, :n]
    return out


class LAVisHView:
    """An AVE-shaped dataset with 'wave' replaced by the LAVisH 'audio_spec'
    fbank images (the MMIL_Net_v2 input)."""

    def __init__(self, base, *, sample_rate: int = 16_000, size: int = 192):
        self.base = base
        self.sample_rate = sample_rate
        self.size = size

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = dict(self.base[idx])
        item["audio_spec"] = wave_to_lavish_spec(item.pop("wave"),
                                                 sample_rate=self.sample_rate, size=self.size)
        return item
