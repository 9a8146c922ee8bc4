"""The AVS S4 train step's loss over several steps, kernels against plain versions. (GPU)

    python3 tools/s4_train_curve.py [--steps 8]

S4 trains HTS-AT beside the adapters and the decoder, its weights' gradients
from K1b (the attention bias's) and K2b (the MLP's and norm2's). This runs
`AVSModel(AVSConfig())` with seeded weights and noised gates, as
chip_smoke.py builds it, for `--steps` Adam steps at the recipe's lr on one
seeded batch-4 batch (AVMOE_DETERMINISTIC_TRAIN=1, mixup λ given, the
generator reseeded for each run), in five cases from the same weights:

  bf16 kernels   the model in bf16 through K1 / K2 / K1b / K2b;
  bf16 plain     the same with the attention and MLP cores replaced by
                 their plain versions (`chip_smoke._plain_cores`: float32
                 inside, cast back to bf16), differentiated by autograd;
  f32 kernels    the model in float32 through the kernels;
  f32 plain      the model in float32 through the plain versions;
  bf16 draws     bf16 kernels with the train draws on, as chip_smoke.py's
                 S4 step runs (DropPath, SpecAugment, dropout, router noise,
                 mixup λ drawn), from the same generator seed.

It prints each case's losses a step, and the gradient-norm of HTS-AT's
weights and of the rest at the first step. A loss curve that leaves the
others in the kernels' case alone would point at the backward kernels;
one that all cases share is the model's and the lr's.

Imports nothing of JAX; run from the repo root on a machine with one card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.config import AVSConfig, TrainConfig  # noqa: E402
from avmoe_tpu_torch.models.avs import (  # noqa: E402
    AVSModel, avs_frozen_scopes, make_avs_loss_fn)
from avmoe_tpu_torch.train.state import create_train_state  # noqa: E402
from avmoe_tpu_torch.train.steps import make_train_step  # noqa: E402


def run(label: str, dtype, cores, kept, batch, steps: int, draws: bool = False):
    import avmoe_tpu_torch.ops.swin as swin

    cfg = AVSConfig()
    model = AVSModel(cfg, dtype=dtype, device="cuda", seed=None)
    model.load_state_dict(kept)
    lr = TrainConfig().lr
    state = create_train_state(model, TrainConfig(accum_steps=1, lr=lr, lr_mlp=lr),
                               steps_per_epoch=100, frozen_scopes=avs_frozen_scopes(cfg))
    step = make_train_step(make_avs_loss_fn(model))
    saved = swin.window_attention, swin.mlp_block
    if cores is not None:
        swin.window_attention, swin.mlp_block = cores
    losses, norms = [], None
    try:
        gen = torch.Generator(device="cuda").manual_seed(12)
        if draws:
            batch = {k: v for k, v in batch.items() if k != "mixup_lambda"}
        with contextlib.nullcontext() if draws else cs._deterministic():
            for i in range(steps):
                state, met = step(state, batch, gen)
                losses.append(float(met["loss"]))
                if i == 0:
                    sq = {"htsat": 0.0, "rest": 0.0}
                    for n, p in state.trainable.items():
                        m = state.optimizer.state.get(p, {}).get("exp_avg")
                        if m is not None:
                            key = "htsat" if n.startswith("encoder.htsat.") else "rest"
                            sq[key] += float(m.float().pow(2).sum())
                    # Adam's first moment after one step is (1 - beta1) g
                    norms = {k: v ** 0.5 / 0.1 for k, v in sq.items()}
    finally:
        swin.window_attention, swin.mlp_block = saved
    print(f"[s4 curve] {label}: losses {[round(v, 5) for v in losses]}; gradient norm at step 1"
          f" HTS-AT {norms['htsat']:.4e}, the rest {norms['rest']:.4e}", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    cs.phase_card()
    cfg = AVSConfig()
    src = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    cs._avs_noised_(src, 1)
    kept = {k: v.clone() for k, v in src.state_dict().items()}
    del src
    batch = cs._avs_batches(cfg, cs.BATCH, 1, 13, "cuda")[0]
    batch["mixup_lambda"] = torch.full_like(batch["mixup_lambda"], 0.6)
    for label, dtype, cores in (("bf16 kernels", torch.bfloat16, None),
                                ("bf16 plain", torch.bfloat16, cs._plain_cores()),
                                ("f32 kernels", torch.float32, None),
                                ("f32 plain", torch.float32, cs._plain_cores())):
        run(label, dtype, cores, kept, batch, args.steps)
    run("bf16 draws", torch.bfloat16, None, kept, batch, args.steps, draws=True)


if __name__ == "__main__":
    main()
