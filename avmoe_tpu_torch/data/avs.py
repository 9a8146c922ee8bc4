"""AVSBench datasets: S4 (single source) and MS3 (multiple sources).

Counterpart of `avmoe_tpu/data/avs.py`, reading the same on-disk layout:

  * S4: `s4_meta_data.csv` (name, split, category columns);
    `visual_frames/<split>/<category>/<name>/<name>_<t>.png`, 5 frames;
    binary masks under `gt_masks/<split>/<category>/<name>/`, one in the
    train split, five in the others; `wave/<split>/<category>/<name>.npy`
  * MS3: `ms3_meta_data.csv` (name, split); `visual_frames/<name>/
    <name>.mp4_<t>.png`; five masks in every split under `gt_masks/<name>/`;
    `wave/<name>.npy`

The meta CSVs are read with the standard `csv` module; PIL is imported
where a mask is decoded. `SyntheticAVSDataset` makes random clips with disc
masks, seeded per index. All yield dicts of numpy arrays (and S4's
category, the video name as strings), equal to the JAX package's for the
same index and seed.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from avmoe_tpu_torch.data.transforms import load_image, pad_or_trim_wave


def _load_mask(path: str, size: int) -> np.ndarray:
    """A mask image, binarized (PIL's mode '1') and resized nearest to (size, size)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("1").resize((size, size), Image.NEAREST)
        return np.asarray(im, dtype=np.float32)


def _split_rows(meta_csv: str, split: str) -> List[Dict[str, str]]:
    with open(meta_csv, newline="") as f:
        return [r for r in csv.DictReader(f) if r["split"] == split]


class S4Dataset:
    NUM_SEGMENTS = 5
    AUDIO_LEN = 32_000
    META = "s4_meta_data.csv"

    def __init__(self, root: str, split: str = "train", img_size: int = 224,
                 mask_size: int = 224):
        self.root = root
        self.split = split
        self.img_size = img_size
        self.mask_size = mask_size
        self.rows = _split_rows(os.path.join(root, self.META), split)

    def __len__(self) -> int:
        return len(self.rows)

    def _wave(self, path: str) -> np.ndarray:
        wave = np.load(path)
        return pad_or_trim_wave(wave.reshape(self.NUM_SEGMENTS, -1).astype(np.float32),
                                self.AUDIO_LEN)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        video, category = row["name"], row["category"]
        base = os.path.join(self.root, "visual_frames", self.split, category, video)
        size = (self.img_size, self.img_size)
        frames = np.stack([load_image(os.path.join(base, f"{video}_{t + 1}.png"), size)
                           for t in range(self.NUM_SEGMENTS)])
        mask_base = os.path.join(self.root, "gt_masks", self.split, category, video)
        n_masks = 1 if self.split == "train" else self.NUM_SEGMENTS
        masks = np.stack([_load_mask(os.path.join(mask_base, f"{video}_{t + 1}.png"),
                                     self.mask_size) for t in range(n_masks)])
        wave = self._wave(os.path.join(self.root, "wave", self.split, category,
                                       f"{video}.npy"))
        return {"images": frames.astype(np.float32), "wave": wave,
                "mask": masks[0] if self.split == "train" else masks,
                "category": category, "video": video}


class MS3Dataset(S4Dataset):
    """MS3: all five masks in every split."""

    META = "ms3_meta_data.csv"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        video = self.rows[idx]["name"]
        base = os.path.join(self.root, "visual_frames", video)
        size = (self.img_size, self.img_size)
        frames = np.stack([load_image(os.path.join(base, f"{video}.mp4_{t + 1}.png"), size)
                           for t in range(self.NUM_SEGMENTS)])
        masks = np.stack([_load_mask(os.path.join(self.root, "gt_masks", video,
                                                  f"{video}_{t + 1}.png"), self.mask_size)
                          for t in range(self.NUM_SEGMENTS)])
        wave = self._wave(os.path.join(self.root, "wave", f"{video}.npy"))
        return {"images": frames.astype(np.float32), "wave": wave, "mask": masks,
                "video": video}


class SyntheticAVSDataset:
    """Random AVS-shaped clips with a disc mask (S4's train split: one mask
    a clip, else one a frame)."""

    def __init__(self, length: int = 8, num_segments: int = 5, audio_len: int = 32_000,
                 img_size: int = 224, mask_size: int = 224, setting: str = "s4",
                 split: str = "train", seed: int = 0):
        self.length = length
        self.num_segments = num_segments
        self.audio_len = audio_len
        self.img_size = img_size
        self.mask_size = mask_size
        self.setting = setting
        self.split = split
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 31337 + idx)
        T, S = self.num_segments, self.mask_size
        cy, cx, r = rng.randint(S // 4, 3 * S // 4, 2).tolist() + [S // 5]
        yy, xx = np.mgrid[0:S, 0:S]
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.float32)
        mask = blob if self.setting == "s4" and self.split == "train" else np.stack([blob] * T)
        return {
            "images": rng.rand(T, self.img_size, self.img_size, 3).astype(np.float32),
            "wave": rng.randn(T, self.audio_len).astype(np.float32) * 0.1,
            "mask": mask,
        }
