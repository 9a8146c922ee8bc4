"""Dataset preprocessing: frames and audio out of raw videos.

Counterpart of `avmoe_tpu/cli/preprocess.py` (the reference's preprocessing
scripts): ffmpeg extracts frames at --fps and a mono wav at --sample_rate,
and the wav becomes a (num_segments, sample_rate) float32 .npy pack of
one-second segments. Host code; needs the `ffmpeg` binary and exits with a
clear message without it.

Usage:
  python -m avmoe_tpu_torch.cli.preprocess --video_dir raw/ --out_dir data/ \\
      --fps 1 --num_segments 5 --sample_rate 32000
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import wave as wavelib
from typing import Optional, Sequence

import numpy as np


def wav_to_pack(wav: str, sample_rate: int, num_segments: int) -> np.ndarray:
    """A 16-bit mono wav -> (num_segments, sample_rate) float32: one-second
    segments at evenly spaced starts, the audio zero-padded to
    num_segments seconds if shorter."""
    with wavelib.open(wav) as f:
        n = f.getnframes()
        data = np.frombuffer(f.readframes(n), dtype=np.int16)
    data = data.astype(np.float32) / 32767.0
    seg = sample_rate
    need = num_segments * seg
    if len(data) < need:
        data = np.pad(data, (0, need - len(data)))
    idx = np.linspace(0, len(data) - seg, num_segments).astype(int)
    return np.stack([data[i: i + seg] for i in idx])


def extract(video: str, out_dir: str, fps: float, sample_rate: int,
            num_segments: int) -> None:
    name = os.path.splitext(os.path.basename(video))[0]
    frame_dir = os.path.join(out_dir, "frames", name)
    os.makedirs(frame_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video,
         "-vf", f"fps={fps}", os.path.join(frame_dir, "%04d.jpg")],
        check=True)
    wav = os.path.join(out_dir, "wave", f"{name}.wav")
    os.makedirs(os.path.dirname(wav), exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video,
         "-ac", "1", "-ar", str(sample_rate), wav],
        check=True)
    np.save(os.path.join(out_dir, "wave", f"{name}.npy"),
            wav_to_pack(wav, sample_rate, num_segments))
    os.remove(wav)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--fps", type=float, default=1.0)
    p.add_argument("--num_segments", type=int, default=5)
    p.add_argument("--sample_rate", type=int, default=32_000)
    args = p.parse_args(argv)

    if shutil.which("ffmpeg") is None:
        sys.exit("ffmpeg binary not found on PATH; install it to preprocess videos")

    videos = sorted(sum([glob.glob(os.path.join(args.video_dir, f"*.{ext}"))
                         for ext in ("mp4", "mkv", "avi", "webm")], []))
    if not videos:
        raise FileNotFoundError(f"no videos found under {args.video_dir}")
    for i, v in enumerate(videos):
        extract(v, args.out_dir, args.fps, args.sample_rate, args.num_segments)
        if i % 25 == 0:
            print(f"[{i}/{len(videos)}] {v}")
    print(f"done: {len(videos)} videos -> {args.out_dir}")


if __name__ == "__main__":
    main()
