"""AVVP training driver: `python -m avmoe_tpu_torch.cli.train_avvp [--synthetic] ...`

Counterpart of `avmoe_tpu/cli/train_avvp.py`, with its flags and defaults:
build the MGN model, freeze the backbones, Adam + StepLR + gradient
accumulation, then per epoch a pass of train steps and the segment- and
event-level F1 suite over the validation clips; the checkpoint is saved
where the segment-level Type@Avg F1 is the best so far. `--resume`
continues from the latest full state at the next epoch, `--mode test`
evaluates the latest (best) checkpoint's weights.

It runs on the card (`--device cuda`, the default; it raises if there is
none); `--device cpu` runs it on the CPU, through the kernels' plain
versions. `--bf16` (on by default) runs the backbones in bfloat16,
`--no-bf16` in float32. The clips come from the LLP layout under
`--data_root` with the label and annotation CSVs named by the flags, or
from `SyntheticAVVPDataset` with `--synthetic` or without a data root; the
synthetic ground-truth grids hold each weak label over the whole clip.

    python -m avmoe_tpu_torch.cli.train_avvp --tiny --synthetic --device cpu --no-bf16 \\
        --epochs 2 --batch_size 2 --accum_itr 2 --num_workers 2 --model_save_dir /tmp/ck
"""

from __future__ import annotations

import argparse
import logging
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
from avmoe_tpu_torch.cli import add_port_flags, fused_switches
from avmoe_tpu_torch.config import (
    AVVPConfig, TrainConfig, mini_avvp_config, replace, tiny_avvp_config)
from avmoe_tpu_torch.data.avvp import LLPDataset, SyntheticAVVPDataset, parse_eval_annotations
from avmoe_tpu_torch.data.loader import BatchLoader
from avmoe_tpu_torch.metrics.avvp import AVVPEvaluator
from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn
from avmoe_tpu_torch.parallel.mesh import gather_ordered, launch, loader_kw, replicate
from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
from avmoe_tpu_torch.train.freeze import param_report
from avmoe_tpu_torch.train.loop import resume_latest, step_generator, train_epoch
from avmoe_tpu_torch.train.state import create_train_state
from avmoe_tpu_torch.train.steps import make_train_step
from avmoe_tpu_torch.utils.runtime import pipelined

log = logging.getLogger("avmoe_tpu_torch.avvp")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["train", "test"], default="train")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--label_train", type=str, default="data/AVVP/AVVP_train.csv")
    p.add_argument("--label_val", type=str, default="data/AVVP/AVVP_val_pd.csv")
    p.add_argument("--eval_audio_csv", type=str, default="data/AVVP/AVVP_eval_audio.csv")
    p.add_argument("--eval_visual_csv", type=str, default="data/AVVP/AVVP_eval_visual.csv")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mini", action="store_true",
                   help="tiny widths at the real dataset's clip geometry")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--accum_itr", type=int, default=8)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--model_save_dir", type=str, default="checkpoints/avvp")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint (full train state) and continue at "
                        "the next epoch")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--precise", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always computes float32 "
                        "attention logits and the erf GELU")
    add_port_flags(p)
    return p.parse_args(argv)


def evaluate(model: MGNModel, loader, gt_audio: Mapping[int, np.ndarray],
             gt_visual: Mapping[int, np.ndarray], num_segments: int = 10,
             tracker: Optional[ExpertUsageTracker] = None) -> Dict[str, float]:
    """The F1 suite over a loader's clips; gt_* map clip_index -> (25, T)
    grids (all zeros where a clip has none). Batch i's readback overlaps
    the device's work on the batches after it; under a process group each
    rank runs its own batches and the F1 bookkeeping replays every rank's
    in batch order (`gather_ordered`)."""

    def fwd(b):
        out = model(b["wave"], b["images"], b["video_st"])
        return out["global_prob"], out["a_frame_prob"], out["v_frame_prob"], out["telemetry"]

    records = []
    for batch, (gp, ap, vp, telemetry) in pipelined(fwd, loader):
        probs = tuple(t.float().cpu().numpy() for t in (gp, ap, vp))
        records.append((probs, batch["clip_index"].tolist(),
                        ExpertUsageTracker.to_host(telemetry)))
    evaluator = AVVPEvaluator()
    blank = np.zeros((25, num_segments), np.int64)
    for (gp, ap, vp), clips, stacks in gather_ordered(records):
        if tracker is not None:
            tracker.add(stacks)
        for i, clip in enumerate(clips):
            evaluator.add_clip(gp[i], ap[i], vp[i], gt_audio.get(int(clip), blank),
                               gt_visual.get(int(clip), blank))
    return evaluator.summary()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the driver; returns the best validation F1 suite (train) or the
    test one (--mode test)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    args = parse_args(argv)
    with launch(args.device) as (mesh, dev):
        return _run(args, dev, mesh)


def _run(args: argparse.Namespace, dev: torch.device, mesh) -> Dict[str, float]:
    if args.precise:
        log.info("--precise: the port always runs float32 attention logits and the erf GELU")
    cfg = mini_avvp_config() if args.mini else tiny_avvp_config() if args.tiny else AVVPConfig()
    tcfg = TrainConfig(batch_size=args.batch_size, accum_steps=args.accum_itr,
                       epochs=args.epochs, lr=args.lr, lr_mlp=args.lr, seed=args.seed,
                       dtype="bfloat16" if args.bf16 else "float32")

    if args.synthetic or args.data_root is None:
        geometry = dict(num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                        img_size=cfg.swin.img_size, st_dim=cfg.st_dim)
        train_ds = SyntheticAVVPDataset(length=8 * args.batch_size, **geometry)
        val_ds = SyntheticAVVPDataset(length=2 * args.batch_size, seed=1, **geometry)
        # the weak labels held over the whole clip
        gt_audio = {i: np.repeat(val_ds[i]["labels"][:, None].astype(np.int64),
                                 cfg.num_segments, axis=1) for i in range(len(val_ds))}
        gt_visual = gt_audio
    else:
        train_ds = LLPDataset(args.data_root, args.label_train, cfg.swin.img_size)
        val_ds = LLPDataset(args.data_root, args.label_val, cfg.swin.img_size)
        # the r2plus1d features' width is the data's, as the JAX model's
        # Dense takes it from the first sample at init
        cfg = replace(cfg, st_dim=int(train_ds[0]["video_st"].shape[-1]))
        blank = np.zeros((25, 10), np.int64)
        a_by_name = parse_eval_annotations(args.eval_audio_csv)
        v_by_name = parse_eval_annotations(args.eval_visual_csv)
        gt_audio = {i: a_by_name.get(n, blank) for i, n in enumerate(val_ds.filenames)}
        gt_visual = {i: v_by_name.get(n, blank) for i, n in enumerate(val_ds.filenames)}

    train_loader = BatchLoader(train_ds, tcfg.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=tcfg.seed, device=dev,
                               **loader_kw(mesh))
    val_loader = BatchLoader(val_ds, tcfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers, device=dev,
                             **loader_kw(mesh, "batches"))

    model = MGNModel(cfg, dtype=getattr(torch, tcfg.dtype), device=dev, seed=tcfg.seed,
                     **fused_switches())
    replicate(model)
    report = param_report(model)
    log.info("params: trainable %.4f%% total %.1fM", report["trainable_pct"],
             report["total"] / 1e6)

    state = create_train_state(model, tcfg, steps_per_epoch=len(train_loader))
    train_step = make_train_step(make_avvp_loss_fn(model))
    ckpts = CheckpointManager(args.model_save_dir)
    tracker = ExpertUsageTracker(cfg.moe.num_experts)
    start_epoch = resume_latest(ckpts, state, train_loader) if args.resume else 1

    if args.mode == "test":
        ckpts.restore(state, params_only=True)
        summary = evaluate(model, val_loader, gt_audio, gt_visual, cfg.num_segments,
                           tracker=tracker)
        tracker.save(args.model_save_dir)
        log.info("test F1 suite: %s", {k: round(v, 2) for k, v in summary.items()})
        return summary

    generator = step_generator(tcfg.seed, dev)
    best, best_summary = -math.inf, {}
    for epoch in range(start_epoch, tcfg.epochs + 1):
        state, meter = train_epoch(state, train_step, train_loader, generator, epoch)
        tracker.reset()
        summary = evaluate(model, val_loader, gt_audio, gt_visual, cfg.num_segments,
                           tracker=tracker)
        val = summary["seg_type_avg"]
        log.info("epoch %d: loss %.4f seg Type@Avg %.2f Event@Avg %.2f event Type@Avg %.2f",
                 epoch, meter.get("loss"), val, summary["seg_event_avg"],
                 summary["event_type_avg"])
        if val >= best:
            best, best_summary = val, summary
            ckpts.save_if_best(state.step, state, val)
    tracker.save(args.model_save_dir)
    log.info("best seg Type@Avg: %.2f", best)
    return best_summary


if __name__ == "__main__":
    main()
