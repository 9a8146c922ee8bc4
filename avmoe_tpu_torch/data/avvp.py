"""LLP dataset for AVVP: frames, waveform, r2plus1d features, weak labels.

Counterpart of `avmoe_tpu/data/avvp.py`, reading the same on-disk layout:

  * a tab-separated label CSV with 'filename' and 'event_labels' (comma-
    joined category names) columns; the clip id is the filename's first 11
    characters
  * `frames/<id>/0001.jpg` .. `0010.jpg`: one frame per segment
  * `wave/<id>.npy`: the clip's waveform, (10, L) or flat
  * `r2plus1d_18/<id>.npy`: (10, 512) r2plus1d clip features

`parse_eval_annotations` turns AVVP_eval_{audio,visual}.csv (tab-separated
filename, onset, offset, event_labels rows) into (25, 10) ground-truth grids
for the F1 evaluator. The CSVs are read with the standard `csv` module.
`SyntheticAVVPDataset` makes random data of the same schema, seeded per
index. Both yield dicts of numpy arrays, bit-identical to the JAX package's
for the same index and seed.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from avmoe_tpu_torch.data.transforms import load_image, pad_or_trim_wave

CATEGORIES = [
    "Speech", "Car", "Cheering", "Dog", "Cat", "Frying_(food)",
    "Basketball_bounce", "Fire_alarm", "Chainsaw", "Cello", "Banjo",
    "Singing", "Chicken_rooster", "Violin_fiddle", "Vacuum_cleaner",
    "Baby_laughter", "Accordion", "Lawn_mower", "Motorcycle", "Helicopter",
    "Acoustic_guitar", "Telephone_bell_ringing", "Baby_cry_infant_cry",
    "Blender", "Clapping",
]
ID_TO_IDX = {c: i for i, c in enumerate(CATEGORIES)}


def read_tsv(path: str) -> List[Dict[str, str]]:
    """The rows of a tab-separated file with a header line, as dicts."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def parse_eval_annotations(csv_path: str) -> Dict[str, np.ndarray]:
    """AVVP_eval_{audio,visual}.csv -> {filename: (25, 10) binary grid}."""
    grids: Dict[str, np.ndarray] = {}
    for row in read_tsv(csv_path):
        grid = grids.setdefault(row["filename"],
                                np.zeros((len(CATEGORIES), 10), dtype=np.int64))
        onset, offset = int(float(row["onset"])), int(float(row["offset"]))
        grid[ID_TO_IDX[row["event_labels"]], onset:offset] = 1
    return grids


class LLPDataset:
    NUM_SEGMENTS = 10
    AUDIO_LEN = 32_000

    def __init__(self, root: str, label_csv: str, img_size: int = 192):
        self.root = root
        self.img_size = img_size
        self.rows = read_tsv(label_csv)
        self.filenames = [r["filename"] for r in self.rows]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        name = row["filename"][:11]
        labels = np.zeros(len(CATEGORIES), dtype=np.float32)
        for cat in (row["event_labels"] or "").split(","):
            if cat in ID_TO_IDX:
                labels[ID_TO_IDX[cat]] = 1.0
        size = (self.img_size, self.img_size)
        frames = np.stack([
            load_image(os.path.join(self.root, "frames", name, f"{t:04d}.jpg"), size)
            for t in range(1, self.NUM_SEGMENTS + 1)])
        wave = np.load(os.path.join(self.root, "wave", f"{name}.npy"))
        wave = pad_or_trim_wave(wave.reshape(self.NUM_SEGMENTS, -1).astype(np.float32),
                                self.AUDIO_LEN)
        video_st = np.load(os.path.join(self.root, "r2plus1d_18", f"{name}.npy"))
        return {"wave": wave, "images": frames.astype(np.float32),
                "video_st": video_st.astype(np.float32), "labels": labels,
                "clip_index": np.int64(idx)}


class SyntheticAVVPDataset:
    """Random LLP-shaped data, deterministic per index; at least one weak
    label a clip."""

    def __init__(self, length: int = 16, num_segments: int = 10, audio_len: int = 32_000,
                 img_size: int = 192, st_dim: int = 512, num_classes: int = 25,
                 seed: int = 0):
        self.length = length
        self.num_segments = num_segments
        self.audio_len = audio_len
        self.img_size = img_size
        self.st_dim = st_dim
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 7919 + idx)
        labels = (rng.rand(self.num_classes) < 0.1).astype(np.float32)
        if labels.sum() == 0:
            labels[rng.randint(self.num_classes)] = 1.0
        T, S = self.num_segments, self.img_size
        return {
            "wave": rng.randn(T, self.audio_len).astype(np.float32) * 0.1,
            "images": rng.rand(T, S, S, 3).astype(np.float32),
            "video_st": rng.randn(T, self.st_dim).astype(np.float32),
            "labels": labels,
            "clip_index": np.int64(idx),
        }
