"""AVQA training driver, two stages: `python -m avmoe_tpu_torch.cli.train_avqa ...`

Counterpart of `avmoe_tpu/cli/train_avqa.py`, with its flags and defaults.
Stage A (`--stage grounding`) pretrains the grounding heads of
`AVQAGroundingModel` on the frozen backbones, one segment a sample (the
loader's (B, T, ...) clips as B*T samples); its validation metric is the
negated mean train loss of the epoch. Stage B (`--stage avst`, the default)
trains `AVQAFusionModel`, after grafting the stage-A heads fc_a1, fc_a2,
fc_gl and fc1 .. fc4 from `--grounding_ckpt` (a stage-A run's checkpoint
directory, whose latest step is its best, one step's directory or its
state.pt), and evaluates the overall and per-question-type answer accuracy.
Each epoch's checkpoint is saved where its metric is the best so far;
`--resume` continues from the latest full state at the next epoch.

It runs on the card (`--device cuda`, the default; it raises if there is
none); `--device cpu` runs it on the CPU, through the kernels' plain
versions. `--bf16` (on by default) runs the backbones in bfloat16,
`--no-bf16` in float32. The questions come from the MUSIC-AVQA layout under
`--data_root` (the vocab files there, or named by the flags, win over the
vocabularies built from the train JSON), or from `SyntheticAVQADataset`
with `--synthetic` or without a data root.

    python -m avmoe_tpu_torch.cli.train_avqa --stage grounding --tiny --synthetic \\
        --device cpu --no-bf16 --epochs 1 --model_save_dir /tmp/grd
    python -m avmoe_tpu_torch.cli.train_avqa --tiny --synthetic --device cpu --no-bf16 \\
        --epochs 2 --grounding_ckpt /tmp/grd --model_save_dir /tmp/avst
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from typing import Dict, Optional, Sequence

import torch

from avmoe_tpu_torch.checkpoint.manager import STATE_FILE, CheckpointManager
from avmoe_tpu_torch.cli import add_port_flags, fused_switches
from avmoe_tpu_torch.config import AVQAConfig, TrainConfig, mini_avqa_config, tiny_avqa_config
from avmoe_tpu_torch.data.avqa import AVQADataset, SyntheticAVQADataset
from avmoe_tpu_torch.data.loader import BatchLoader
from avmoe_tpu_torch.metrics.avqa import AVQAAccuracy
from avmoe_tpu_torch.models.avqa import AVQAFusionModel, make_avqa_loss_fn
from avmoe_tpu_torch.models.avqa_grounding import AVQAGroundingModel, make_grounding_loss_fn
from avmoe_tpu_torch.parallel.mesh import gather_ordered, launch, loader_kw, replicate
from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
from avmoe_tpu_torch.train.freeze import param_report
from avmoe_tpu_torch.train.loop import resume_latest, step_generator, train_epoch
from avmoe_tpu_torch.train.state import create_train_state
from avmoe_tpu_torch.train.steps import make_train_step
from avmoe_tpu_torch.utils.runtime import pipelined

log = logging.getLogger("avmoe_tpu_torch.avqa")

# the stage-A heads stage B takes over, as load_partial's '/'-joined names
GROUNDING_HEADS = r"^(fc_a1|fc_a2|fc_gl|fc1|fc2|fc3|fc4)/"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--stage", choices=["grounding", "avst"], default="avst")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--label_train", type=str, default="json/avqa-train.json")
    p.add_argument("--label_val", type=str, default="json/avqa-val.json")
    p.add_argument("--ques_vocab", type=str, default=None,
                   help="ques_vocab.txt (one token a line); found under data_root when there")
    p.add_argument("--ans_vocab", type=str, default=None,
                   help="ans_vocab.txt (one answer a line); found under data_root when there")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--mini", action="store_true",
                   help="tiny widths at the real dataset's clip geometry")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--accum_itr", type=int, default=4)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--model_save_dir", type=str, default="checkpoints/avqa")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint (full train state) and continue at "
                        "the next epoch")
    p.add_argument("--grounding_ckpt", type=str, default=None,
                   help="stage-A checkpoint to graft the grounding heads from")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--precise", action="store_true",
                   help="accepted for the JAX CLI's sake: the port always computes float32 "
                        "attention logits and the erf GELU")
    add_port_flags(p)
    return p.parse_args(argv)


def build_datasets(args, cfg: AVQAConfig):
    """(train, val) datasets: synthetic, or the MUSIC-AVQA JSONs under data_root."""
    if args.synthetic or args.data_root is None:
        def synthetic(n: int, seed: int) -> SyntheticAVQADataset:
            return SyntheticAVQADataset(
                length=n, num_segments=cfg.num_segments, audio_len=cfg.audio_len,
                img_size=cfg.swin.img_size, qst_vocab=cfg.qst_vocab,
                max_qst_len=cfg.max_qst_len, answer_vocab=cfg.answer_vocab, seed=seed)
        return synthetic(8 * args.batch_size, 0), synthetic(2 * args.batch_size, 1)
    train_json = os.path.join(args.data_root, args.label_train)

    def vocab(flag: Optional[str], name: str) -> Optional[str]:
        if flag:
            return flag
        cand = os.path.join(args.data_root, name)
        return cand if os.path.exists(cand) else None

    vk = dict(ques_vocab_file=vocab(args.ques_vocab, "ques_vocab.txt"),
              ans_vocab_file=vocab(args.ans_vocab, "ans_vocab.txt"))
    if vk["ques_vocab_file"] or vk["ans_vocab_file"]:
        log.info("AVQA vocab files: ques=%s ans=%s", vk["ques_vocab_file"],
                 vk["ans_vocab_file"])
    return (AVQADataset(args.data_root, train_json, train_json, cfg.swin.img_size, **vk),
            AVQADataset(args.data_root, os.path.join(args.data_root, args.label_val),
                        train_json, cfg.swin.img_size, **vk))


def segments(batch: Dict) -> Dict:
    """A batch of clips as one sample a segment: (B, T, ...) -> (B*T, ...)."""
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    return {"wave": flat(batch["wave"]), "posi": flat(batch["visual_posi"]),
            "nega": flat(batch["visual_nega"])}


def load_grounding_heads(model: AVQAFusionModel, path: str) -> None:
    """Graft the stage-A heads of the checkpoint at `path` (a checkpoint
    directory: its latest step; a step directory; or a state.pt file) into
    `model`, in place."""
    if os.path.isdir(path) and not os.path.isfile(os.path.join(path, STATE_FILE)):
        donor = CheckpointManager(path).load(map_location="cpu")
    else:
        file = os.path.join(path, STATE_FILE) if os.path.isdir(path) else path
        donor = torch.load(file, map_location="cpu", weights_only=True)
    grafted = CheckpointManager.load_partial(model.state_dict(), donor["model"],
                                             include=GROUNDING_HEADS)
    model.load_state_dict(grafted)


def evaluate(model: AVQAFusionModel, loader, tracker: Optional[ExpertUsageTracker] = None
             ) -> Dict[str, float]:
    """Overall and per-question-type accuracy (percent) over a loader's
    questions; batch i's readback overlaps the device's work on the batches
    after it. Under a process group each rank runs its own batches and the
    bookkeeping replays every rank's in batch order (`gather_ordered`)."""
    answer_vocab = model.cfg.answer_vocab

    def predict(b):
        out = model(b["wave"], b["visual_posi"], b["visual_nega"], b["question"])
        return out["qa_logits"][:, :answer_vocab].argmax(dim=-1), out["telemetry"]

    records = []
    for b, (pred, telemetry) in pipelined(predict, loader):
        records.append((pred.cpu().numpy(), b["answer"].cpu().numpy(),
                        [str(t) for t in b["qtype_str"]], ExpertUsageTracker.to_host(telemetry)))
    acc = AVQAAccuracy()
    for pred, answer, qtypes, stacks in gather_ordered(records):
        if tracker is not None:
            tracker.add(stacks)
        acc.update(pred, answer, qtypes)
    return acc.summary()


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Run the driver; returns the best epoch's metric (grounding: the
    negated mean train loss; avst: the overall validation accuracy)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", force=True)
    args = parse_args(argv)
    with launch(args.device) as (mesh, dev):
        return _run(args, dev, mesh)


def _run(args: argparse.Namespace, dev: torch.device, mesh) -> float:
    if args.precise:
        log.info("--precise: the port always runs float32 attention logits and the erf GELU")
    cfg = mini_avqa_config() if args.mini else tiny_avqa_config() if args.tiny else AVQAConfig()
    tcfg = TrainConfig(batch_size=args.batch_size, accum_steps=args.accum_itr,
                       epochs=args.epochs, lr=args.lr, lr_mlp=args.lr, seed=args.seed,
                       dtype="bfloat16" if args.bf16 else "float32")
    train_ds, val_ds = build_datasets(args, cfg)
    train_loader = BatchLoader(train_ds, tcfg.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=tcfg.seed, device=dev,
                               **loader_kw(mesh))
    val_loader = BatchLoader(val_ds, tcfg.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers, device=dev,
                             **loader_kw(mesh, "batches"))

    dtype = getattr(torch, tcfg.dtype)
    grounding = args.stage == "grounding"
    if grounding:
        model = AVQAGroundingModel(cfg, dtype=dtype, device=dev, seed=tcfg.seed)
        loss_fn = make_grounding_loss_fn(model)
    else:
        model = AVQAFusionModel(cfg, dtype=dtype, device=dev, seed=tcfg.seed,
                                **fused_switches())
        if args.grounding_ckpt:
            load_grounding_heads(model, args.grounding_ckpt)
        loss_fn = make_avqa_loss_fn(model)
    replicate(model)
    report = param_report(model)
    log.info("params: trainable %.4f%% total %.1fM", report["trainable_pct"],
             report["total"] / 1e6)

    state = create_train_state(model, tcfg, steps_per_epoch=len(train_loader))
    train_step = make_train_step(loss_fn)
    ckpts = CheckpointManager(args.model_save_dir)
    start_epoch = resume_latest(ckpts, state, train_loader) if args.resume else 1

    tracker = ExpertUsageTracker(cfg.moe.num_experts)
    generator = step_generator(tcfg.seed, dev)
    best = -math.inf
    for epoch in range(start_epoch, tcfg.epochs + 1):
        batches = map(segments, train_loader) if grounding else train_loader
        state, meter = train_epoch(state, train_step, batches, generator, epoch)
        if grounding:
            val = -meter.get("loss")
            log.info("epoch %d: grounding loss %.4f", epoch, meter.get("loss"))
        else:
            summary = evaluate(model, val_loader, tracker)
            val = summary["overall"]
            log.info("epoch %d: loss %.4f acc %.2f per-type %s", epoch, meter.get("loss"), val,
                     {k: round(v, 1) for k, v in summary.items()})
        if val >= best:
            best = val
            ckpts.save_if_best(state.step, state, val)
    tracker.save(args.model_save_dir)
    log.info("best: %.4f", best)
    return best


if __name__ == "__main__":
    main()
