"""AVS training driver, S4 and MS3: `python -m avmoe_tpu_torch.cli.train_avs ...`

Counterpart of `avmoe_tpu/cli/train_avs.py`, with its flags and defaults:
`build_config` resolves the setting's published recipe (S4: no masked
audio-visual loss, no load-balance loss, HTS-AT trains; MS3: the KL masked
audio-visual loss at 0.5 over all four stages, the load-balance loss at
0.01, 'token' experts, temporal gamma 0.1, both backbones frozen) with the
flags over it. Training archives the package's sources beside the
checkpoints, then per epoch runs the train steps and the mask IoU and
F-measure over every validation frame; the checkpoint is saved where the
mIoU is the best so far. `--resume` continues from the latest full state at
the next epoch; `--mode test` evaluates the latest (best) checkpoint's
weights and, with `--save_pred_mask`, writes the binarized predicted masks
as PNGs under `<model_save_dir>/pred_masks`.

It runs on the card (`--device cuda`, the default; it raises if there is
none); `--device cpu` runs it on the CPU, through the kernels' plain
versions. `--bf16` (on by default) runs the backbones in bfloat16,
`--no-bf16` in float32. The clips come from the AVSBench layout under
`--data_root`, or from `SyntheticAVSDataset` with `--synthetic` or without
a data root.

    python -m avmoe_tpu_torch.cli.train_avs --setting s4 --tiny --synthetic --device cpu \\
        --no-bf16 --max_epoches 2 --train_batch_size 2 --accum_itr 2 --num_workers 2 \\
        --model_save_dir /tmp/ck
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
from avmoe_tpu_torch.cli import add_port_flags, fused_switches
from avmoe_tpu_torch.config import (
    AVSConfig, TrainConfig, mini_avs_config, replace, tiny_avs_config)
from avmoe_tpu_torch.data.avs import MS3Dataset, S4Dataset, SyntheticAVSDataset
from avmoe_tpu_torch.data.loader import BatchLoader
from avmoe_tpu_torch.metrics.avs import eval_fmeasure, mask_iou, save_mask
from avmoe_tpu_torch.models.avs import AVSModel, avs_frozen_scopes, make_avs_loss_fn
from avmoe_tpu_torch.parallel.mesh import (data_parallel, gather_ordered, launch,
                                          loader_kw, replicate)
from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
from avmoe_tpu_torch.train.freeze import param_report
from avmoe_tpu_torch.train.loop import resume_latest, step_generator, train_epoch
from avmoe_tpu_torch.train.state import create_train_state
from avmoe_tpu_torch.train.steps import make_train_step
from avmoe_tpu_torch.utils.runtime import archive_sources, pipelined

log = logging.getLogger("avmoe_tpu_torch.avs")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["train", "test"], default="train",
                   help="test = restore the latest checkpoint's weights, evaluate and, with "
                        "--save_pred_mask, save the predicted masks")
    p.add_argument("--save_pred_mask", action="store_true")
    p.add_argument("--setting", choices=["s4", "ms3"], default="s4")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mini", action="store_true",
                   help="tiny widths at the real dataset's clip geometry")
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--accum_itr", type=int, default=4)
    p.add_argument("--max_epoches", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tpavi_stages", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--sa_loss_flag", action="store_true",
                   help="force the masked audio-visual term on (on by default for ms3)")
    p.add_argument("--no_sa_loss", action="store_true",
                   help="force the masked audio-visual term off")
    p.add_argument("--lambda_1", type=float, default=None,
                   help="masked audio-visual weight; default the recipe's (s4: 0, ms3: 0.5)")
    p.add_argument("--sa_loss_kind", choices=["cosine", "euclidean", "kl"], default=None,
                   help="masked audio-visual flavor (default s4: cosine, ms3: kl)")
    p.add_argument("--sa_norm_fea", type=int, default=None,
                   help="normalize the audio / visual features in the masked audio-visual "
                        "term (default s4: 1, ms3: 0)")
    p.add_argument("--sa_threshold", type=int, default=None,
                   help="threshold the pooled masks at 0.5 in the masked audio-visual term "
                        "(default s4: 1, ms3: 0)")
    p.add_argument("--masked_av_stages", type=int, nargs="*", default=None,
                   help="stages the masked audio-visual term covers (default: all "
                        "--tpavi_stages when the term is on)")
    p.add_argument("--closer_loss", action="store_true",
                   help="nearest-audio pairing in the masked audio-visual term")
    p.add_argument("--load_balancing_loss_weight", type=float, default=None,
                   help="load-balance weight in the train total; default the recipe's "
                        "(s4: 0, off; ms3: 0.01)")
    p.add_argument("--model_save_dir", type=str, default="checkpoints/avs")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint (full train state) and continue at "
                        "the next epoch")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--precise", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always computes float32 "
                        "attention logits and the erf GELU")
    add_port_flags(p)
    return p.parse_args(argv)


def build_config(args) -> AVSConfig:
    """The AVSConfig of the flags over the setting's recipe defaults."""
    cfg = mini_avs_config() if args.mini else tiny_avs_config() if args.tiny else AVSConfig()
    ms3 = args.setting == "ms3"
    sa_on = (args.sa_loss_flag or ms3) and not args.no_sa_loss
    stages = (tuple(args.masked_av_stages) if args.masked_av_stages is not None
              else tuple(args.tpavi_stages))
    cfg = replace(
        cfg, setting=args.setting, tpavi_stages=tuple(args.tpavi_stages), sa_loss_flag=sa_on,
        lambda_1=args.lambda_1 if args.lambda_1 is not None else 0.5 if ms3 else 0.0,
        sa_loss_kind=args.sa_loss_kind or ("kl" if ms3 else "cosine"),
        sa_norm_fea=bool(args.sa_norm_fea) if args.sa_norm_fea is not None else not ms3,
        sa_threshold=bool(args.sa_threshold) if args.sa_threshold is not None else not ms3,
        closer_loss=args.closer_loss, sa_loss_stages=stages if sa_on else ())
    if ms3:
        cfg = replace(cfg, temporal_gamma=0.1, lb_loss_weight=0.01,
                      moe=dataclasses.replace(cfg.moe, adapter=dataclasses.replace(
                          cfg.moe.adapter, self_attention="token")))
    if args.load_balancing_loss_weight is not None:
        cfg = replace(cfg, lb_loss_weight=args.load_balancing_loss_weight)
    return cfg


def evaluate(model: AVSModel, loader, tracker: Optional[ExpertUsageTracker] = None,
             mask_dir: Optional[str] = None) -> Tuple[float, float]:
    """(mIoU, F-measure) over every frame's mask of a loader's clips: the IoU
    is the mean of the batches' mean IoUs, the F-measure one over all the
    frames. With `mask_dir`, each predicted mask is saved there as
    `batch<i>_<j>.png`. The host's readback of batch i overlaps the
    device's work on the batches after it. Under a process group each rank
    runs its own batches, and every rank's IoUs, masks and telemetry are
    taken in batch order (`gather_ordered`)."""

    def predict(b):
        out = model(b["images"], b["wave"])
        return out["mask_logits"].float(), out["telemetry"]

    records = []
    for batch, (logits, telemetry) in pipelined(predict, loader):
        mask = batch["mask"].reshape((-1,) + tuple(batch["mask"].shape[-2:])).float()
        iou = float(mask_iou(logits, mask))
        if data_parallel():   # every rank's masks come to every rank
            logits, mask = logits.cpu(), mask.cpu()
        records.append((iou, logits, mask, ExpertUsageTracker.to_host(telemetry)))
    ious, preds, gts = [], [], []
    dev = next(model.parameters()).device
    for bi, (iou, logits, mask, stacks) in enumerate(gather_ordered(records)):
        if tracker is not None:
            tracker.add(stacks)
        ious.append(iou)
        preds.append(logits.to(dev))
        gts.append(mask.to(dev))
        if mask_dir is not None:
            save_mask(logits.cpu().numpy(), mask_dir,
                      [f"batch{bi}_{j}" for j in range(logits.shape[0])])
    fscore = float(eval_fmeasure(torch.cat(preds), torch.cat(gts)))
    return float(np.mean(ious)), fscore


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Run the driver; returns the best validation mIoU (train) or the test
    mIoU (--mode test)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    args = parse_args(argv)
    with launch(args.device) as (mesh, dev):
        return _run(args, dev, mesh)


def _run(args: argparse.Namespace, dev: torch.device, mesh) -> float:
    if args.precise:
        log.info("--precise: the port always runs float32 attention logits and the erf GELU")
    cfg = build_config(args)
    tcfg = TrainConfig(batch_size=args.train_batch_size, accum_steps=args.accum_itr,
                       epochs=args.max_epoches, lr=args.lr, lr_mlp=args.lr, seed=args.seed,
                       dtype="bfloat16" if args.bf16 else "float32")

    if args.synthetic or args.data_root is None:
        def synthetic(split: str, n: int, seed: int) -> SyntheticAVSDataset:
            return SyntheticAVSDataset(
                length=n, num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                img_size=cfg.img_size, mask_size=cfg.mask_size, setting=args.setting,
                split=split, seed=seed)
        train_ds = synthetic("train", 4 * tcfg.batch_size, 0)
        val_ds = synthetic("val", 2 * tcfg.batch_size, 1)
    else:
        ds_cls = S4Dataset if args.setting == "s4" else MS3Dataset
        train_ds = ds_cls(args.data_root, "train", cfg.img_size, cfg.mask_size)
        val_ds = ds_cls(args.data_root, "val", cfg.img_size, cfg.mask_size)

    train_loader = BatchLoader(train_ds, tcfg.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=tcfg.seed, device=dev,
                               **loader_kw(mesh))
    val_loader = BatchLoader(val_ds, tcfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers, device=dev,
                             **loader_kw(mesh, "batches"))

    model = AVSModel(cfg, dtype=getattr(torch, tcfg.dtype), device=dev, seed=tcfg.seed,
                     **fused_switches())
    replicate(model)
    # S4's recipe trains HTS-AT; MS3's freezes both backbones
    frozen_scopes = avs_frozen_scopes(cfg)
    report = param_report(model, frozen_scopes)
    log.info("params: trainable %.4f%% total %.1fM", report["trainable_pct"],
             report["total"] / 1e6)

    state = create_train_state(model, tcfg, steps_per_epoch=len(train_loader),
                               frozen_scopes=frozen_scopes)
    train_step = make_train_step(make_avs_loss_fn(model))
    ckpts = CheckpointManager(args.model_save_dir)
    start_epoch = resume_latest(ckpts, state, train_loader) if args.resume else 1
    tracker = ExpertUsageTracker(cfg.moe.num_experts)

    if args.mode == "test":
        ckpts.restore(state, params_only=True)
        mask_dir = f"{args.model_save_dir}/pred_masks" if args.save_pred_mask else None
        miou, fscore = evaluate(model, val_loader, tracker, mask_dir)
        tracker.save(args.model_save_dir)
        log.info("test miou %.4f F %.4f", miou, fscore)
        return miou

    n_archived = archive_sources(args.model_save_dir)
    log.info("archived %d source files to %s/sources", n_archived, args.model_save_dir)

    generator = step_generator(tcfg.seed, dev)
    best = -math.inf
    for epoch in range(start_epoch, tcfg.epochs + 1):
        state, meter = train_epoch(state, train_step, train_loader, generator, epoch)
        tracker.reset()
        miou, fscore = evaluate(model, val_loader, tracker)
        log.info("epoch %d: loss %.4f miou %.4f F %.4f", epoch, meter.get("loss"), miou,
                 fscore)
        if miou >= best:
            best = miou
            ckpts.save_if_best(state.step, state, miou)
    tracker.save(args.model_save_dir)
    log.info("best miou: %.4f", best)
    return best


if __name__ == "__main__":
    main()
