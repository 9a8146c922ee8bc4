"""AVE training driver: `python -m avmoe_tpu_torch.cli.train_ave [--synthetic] ...`

Counterpart of `avmoe_tpu/cli/train_ave.py`, with its flags and defaults:
build the model, freeze the backbones, Adam + StepLR + gradient
accumulation, then the epoch loop with evaluation, best-checkpoint saving,
early stop and expert telemetry; `--resume` continues from the latest full
state, `--mode test` evaluates the latest (best) checkpoint's weights.
`--model v3` is the MoE model (`models/ave.py`); `--model v1` MMIL_Net v1
with its DG-SCT adapters and `--model lavish` the LAVisH MMIL_Net_v2
(`models/ave_legacy.py`), whose datasets `LAVisHView` wraps so that each
clip's audio arrives as fbank images.

It runs on the card (`--device cuda`, the default; it raises if there is
none); `--device cpu` runs it on the CPU, through the kernels' plain
versions. `--bf16` (on by default) runs the backbones in bfloat16;
`--no-bf16` in float32. The waveform and frames come from the AVE layout
under `--data_root`, or from `SyntheticAVEDataset` with `--synthetic` or
without a data root.

    python -m avmoe_tpu_torch.cli.train_ave --tiny --synthetic --device cpu --no-bf16 \\
        --epochs 2 --batch_size 2 --accum_itr 2 --num_workers 2 --model_save_dir /tmp/ck
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
from avmoe_tpu_torch.cli import add_port_flags, fused_switches
from avmoe_tpu_torch.config import ave_train_preset, mini_ave_config, replace, tiny_ave_config
from avmoe_tpu_torch.data.ave import AVEDataset, LAVisHView, SyntheticAVEDataset
from avmoe_tpu_torch.data.loader import BatchLoader
from avmoe_tpu_torch.models.ave import AVEModel, make_ave_eval_fn, make_ave_loss_fn
from avmoe_tpu_torch.models.ave_legacy import (MMILNetV1, MMILNetV2, make_mmil_v1_eval_fn,
                                               make_mmil_v1_loss_fn, make_mmil_v2_eval_fn,
                                               make_mmil_v2_loss_fn)
from avmoe_tpu_torch.parallel.mesh import launch, loader_kw, replicate
from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
from avmoe_tpu_torch.train.freeze import param_report
from avmoe_tpu_torch.train.loop import evaluate_batches, resume_latest, train_and_evaluate
from avmoe_tpu_torch.train.state import create_train_state
from avmoe_tpu_torch.train.steps import make_eval_step, make_train_step

log = logging.getLogger("avmoe_tpu_torch")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["v3", "v1", "lavish"], default="v3",
                   help="v3: the MoE model; v1: the DG-SCT MMIL_Net; lavish: the "
                        "shared-backbone MMIL_Net_v2")
    p.add_argument("--mode", choices=["train", "test"], default="train",
                   help="test = restore the latest checkpoint's weights and evaluate")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true", help="random AVE-shaped data")
    p.add_argument("--tiny", action="store_true", help="tiny model (tests)")
    p.add_argument("--mini", action="store_true",
                   help="tiny widths at the real dataset's clip geometry")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--accum_itr", type=int, default=8)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_mlp", type=float, default=5e-6, help="classifier-head LR")
    p.add_argument("--decay", type=float, default=0.35)
    p.add_argument("--decay_epoch", type=int, default=3)
    p.add_argument("--early_stop", type=int, default=20)
    p.add_argument("--seed", type=int, default=999)
    p.add_argument("--model_save_dir", type=str, default="checkpoints/ave")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint (full train state: weights, optimizer, "
                        "step, accumulated gradient) and continue at the next epoch")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--precise", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always computes float32 "
                        "attention logits and the erf GELU")
    add_port_flags(p)
    return p.parse_args(argv)


def _model_kit(name: str):
    """(model class, loss closure maker, eval closure maker) of `--model`."""
    return {"v3": (AVEModel, make_ave_loss_fn, make_ave_eval_fn),
            "v1": (MMILNetV1, make_mmil_v1_loss_fn, make_mmil_v1_eval_fn),
            "lavish": (MMILNetV2, make_mmil_v2_loss_fn, make_mmil_v2_eval_fn)}[name]


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Run the driver; returns the best validation accuracy (train) or the
    test accuracy (--mode test)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    args = parse_args(argv)
    with launch(args.device) as (mesh, dev):
        return _run(args, dev, mesh)


def _run(args: argparse.Namespace, dev: torch.device, mesh) -> float:
    if args.precise:
        log.info("--precise: the port always runs float32 attention logits and the erf GELU")
    cfg, tcfg = ave_train_preset()
    cfg = mini_ave_config() if args.mini else tiny_ave_config() if args.tiny else cfg
    tcfg = replace(tcfg, batch_size=args.batch_size, accum_steps=args.accum_itr,
                   epochs=args.epochs, lr=args.lr, lr_mlp=args.lr_mlp, decay=args.decay,
                   decay_epoch=args.decay_epoch, early_stop=args.early_stop, seed=args.seed,
                   dtype="bfloat16" if args.bf16 else "float32")

    if args.synthetic or args.data_root is None:
        geometry = dict(num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                        img_size=cfg.swin.img_size, num_classes=cfg.num_classes)
        train_ds = SyntheticAVEDataset(length=8 * args.batch_size, **geometry)
        val_ds = SyntheticAVEDataset(length=2 * args.batch_size, seed=1, **geometry)
    else:
        train_ds = AVEDataset(args.data_root, "train", img_size=cfg.swin.img_size)
        val_ds = AVEDataset(args.data_root, "test", img_size=cfg.swin.img_size)
    if args.model == "lavish":
        # the fbank images' side is the Swin input size
        view = dict(sample_rate=cfg.htsat.frontend.sample_rate, size=cfg.swin.img_size)
        train_ds, val_ds = LAVisHView(train_ds, **view), LAVisHView(val_ds, **view)

    train_loader = BatchLoader(train_ds, tcfg.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=tcfg.seed, device=dev,
                               **loader_kw(mesh))
    val_loader = BatchLoader(val_ds, tcfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers, device=dev,
                             **loader_kw(mesh, "batches"))

    Model, make_loss_fn, make_eval_fn = _model_kit(args.model)
    # the legacy models have no MoEAdapter and no fused route
    fused = fused_switches() if args.model == "v3" else {}
    model = Model(cfg, dtype=getattr(torch, tcfg.dtype), device=dev, seed=tcfg.seed, **fused)
    replicate(model)
    report = param_report(model)
    log.info("params: trainable %.4f%% additional %.4f%% total %.1fM",
             report["trainable_pct"], report["additional_pct"], report["total"] / 1e6)

    state = create_train_state(model, tcfg, steps_per_epoch=len(train_loader))
    loss_fn = (make_loss_fn(model) if args.model == "lavish"
               else make_loss_fn(model, mixup_alpha=tcfg.mixup_alpha))
    train_step = make_train_step(loss_fn)
    eval_step = make_eval_step(make_eval_fn(model))
    ckpts = CheckpointManager(args.model_save_dir)
    tracker = ExpertUsageTracker(cfg.moe.num_experts)

    start_epoch = resume_latest(ckpts, state, train_loader) if args.resume else 1

    if args.mode == "test":
        state = ckpts.restore(state, params_only=True)
        accs = []
        # deferred readback: batch i is read while batches i+1, i+2 run
        for scalars, stacks in evaluate_batches(eval_step, state, val_loader):
            tracker.add(stacks)
            accs.append(scalars["accuracy"])
        tracker.save(args.model_save_dir)
        acc = float(np.mean(accs))
        log.info("test accuracy: %.2f over %d batches", acc, len(accs))
        return acc

    state, best = train_and_evaluate(
        state=state, train_step=train_step, eval_step=eval_step,
        train_loader=train_loader, eval_loader=val_loader, epochs=tcfg.epochs,
        seed=tcfg.seed, early_stop=tcfg.early_stop, checkpoints=ckpts,
        expert_tracker=tracker, start_epoch=start_epoch, device=dev)
    tracker.save(args.model_save_dir)
    log.info("best val accuracy: %.2f", best)
    return best


if __name__ == "__main__":
    main()
