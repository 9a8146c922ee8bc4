"""Where an AVS eval forward spends its device time, by PyTorch op and input
shapes, on one GPU.

    python3 tools/avs_profile_ops.py [--batch 4] [--top 25]

Builds `AVSModel(AVSConfig())` in bf16 (seeded weights) on the card, runs
two warm-up forwards at `--batch` clips of 5 frames, then profiles three
with torch.profiler (record_shapes) and prints the ops with the most device
time, grouped by input shapes. Then times each decoder conv alone (CUDA
events) on the channels-last input view, with cuDNN's heuristic algorithm
and in cuDNN's benchmark mode (as `heads/avs.py` `Conv2d` runs it). TF32
off, as `chip_smoke.py` runs. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("avs_profile_ops: needs a GPU (torch.cuda.is_available() is false)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    import chip_smoke as cs
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.models.avs import AVSModel

    cfg = AVSConfig()
    model = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    cs._avs_noised_(model, 1)
    images, wave = cs._avs_inputs(cfg, args.batch, 3, "cuda")
    for _ in range(2):
        model(images, wave)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(3):
            model(images, wave)
        torch.cuda.synchronize()
    print(prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_cuda_time_total", row_limit=args.top, max_name_column_width=40,
        max_shapes_column_width=90), flush=True)

    frames = args.batch * cfg.num_segments
    half = cfg.mask_size // 2
    flags = torch.backends.cudnn.flags
    # (frames, H, C_in, C_out, kernel) of each decoder conv
    convs = [(frames, p, cfg.channel, cfg.channel, 3) for p in cfg.pyramid_sizes]
    convs += [(frames, half, cfg.channel, 128, 3), (frames, cfg.mask_size, 128, 32, 3),
              (frames, cfg.mask_size, 32, 1, 1)]
    for n, hw, ci, co, k in convs:
        x = torch.randn(n, hw, hw, ci, device="cuda")
        w = torch.randn(co, ci, k, k, device="cuda") * 0.05
        b = torch.zeros(co, device="cuda")
        view = x.permute(0, 3, 1, 2)
        def benchmarked():
            with flags(enabled=True, benchmark=True, deterministic=False, allow_tf32=False):
                return F.conv2d(view, w, b, padding=k // 2)

        runs = {"heuristic": lambda: F.conv2d(view, w, b, padding=k // 2),
                "benchmark mode": benchmarked}
        ref = runs["heuristic"]()
        cells = []
        for name, fn in runs.items():
            d = (fn() - ref).abs().max().item()
            cells.append(f"{name} {cs.time_ms(fn, iters=5, warmup=1):.3f} ms (|d| {d:.1e})")
        print(f"conv {k}x{k} ({n}, {ci}, {hw}, {hw}) -> {co}: " + ", ".join(cells), flush=True)


if __name__ == "__main__":
    main()
