"""Dataset audio statistics: the Kaldi fbank mean and std over a dataset.

Counterpart of `avmoe_tpu/cli/compute_audio_stats.py`, with its flags and
`--device` (default cuda): every .npy waveform pack under --wave_dir,
flattened, goes through `audio/kaldi.py` `fbank` in float64 (as the JAX
package's numpy does) on the device, packs of one length a batch; the sums
accumulate in float64. The result is the dataset-level mean and std that the
data loaders normalise fbank features with (e.g. AVE's -5.27 / 4.08).

Usage: python -m avmoe_tpu_torch.cli.compute_audio_stats --wave_dir data/AVE/wave
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avmoe_tpu_torch.audio.kaldi import fbank

PACKS_PER_BATCH = 16


def _batches(files: Sequence[str]):
    """(index of its last file, (n, L) float64 array) of consecutive packs
    of one length, at most PACKS_PER_BATCH of them."""
    group: List[np.ndarray] = []
    for i, f in enumerate(files):
        wave = np.load(f).reshape(-1)
        if group and (len(group) == PACKS_PER_BATCH or len(wave) != len(group[0])):
            yield i - 1, np.stack(group)
            group = []
        group.append(wave)
    if group:
        yield len(files) - 1, np.stack(group)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--wave_dir", required=True, help="dir of .npy waveform packs")
    p.add_argument("--sample_rate", type=float, default=16_000.0)
    p.add_argument("--num_mel_bins", type=int, default=192)
    p.add_argument("--frame_shift_ms", type=float, default=5.2)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.wave_dir, "*.npy")))
    if args.limit:
        files = files[: args.limit]
    if not files:
        raise FileNotFoundError(f"no .npy files under {args.wave_dir}")
    device = torch.device(args.device)

    zero = lambda: torch.zeros((), dtype=torch.float64, device=device)
    total, total_sq, count = zero(), zero(), 0
    start = 0
    for last, waves in _batches(files):
        fb = fbank(torch.from_numpy(waves.astype(np.float64)).to(device),
                   sample_frequency=args.sample_rate, num_mel_bins=args.num_mel_bins,
                   frame_shift_ms=args.frame_shift_ms)
        total += fb.sum()
        total_sq += (fb * fb).sum()
        count += fb.numel()
        if last // 50 != (start - 1) // 50:    # the batch holds a file i, i % 50 == 0
            mean = total.item() / max(count, 1)
            std = math.sqrt(max(total_sq.item() / max(count, 1) - mean**2, 0))
            print(f"[{last}/{len(files)}] running mean={mean:.4f} std={std:.4f}")
        start = last + 1
    mean = total.item() / count
    std = math.sqrt(total_sq.item() / count - mean**2)
    print(f"dataset fbank mean={mean:.6f} std={std:.6f} over {count} values")
    return mean, std


if __name__ == "__main__":
    main()
