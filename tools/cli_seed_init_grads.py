"""The first train steps of a task CLI at the seeded init: where the gradients
blow up, and whether the kernels are the cause. (GPU)

    python3 tools/cli_seed_init_grads.py [--tasks avvp avqa avs]

For each task the model as its CLI builds it at full width (`MGNModel(
AVVPConfig())` seed 23, `AVQAFusionModel(AVQAConfig())` seed 1, S4's
`AVSModel(AVSConfig())` seed 0, HTS-AT trainable), the CLI's first three
train batches (its synthetic set, batch 4, the train loader's first
permutation) and its step generator (the CLI's seed), three micro-steps at
accum 2 (an Adam update after the second) in four variants:

  * bf16 through the kernels (K1 / K2 / K1b / K2b): what the CLI runs;
  * bf16 through the kernels' plain versions in float32 (`chip_smoke._plain_cores`);
  * float32 through the kernels;
  * bf16 through the kernels with AVMOE_DETERMINISTIC_TRAIN=1 (no SpecAugment).

Per micro-step: the loss, the share of HTS-AT's patch tokens with zero
variance (SpecAugment's zeroed stripes through the zero-bias patch embed),
the largest |gradient| in the first audio site's adapters (audio_moe_p1_0,
audio_moe_p2_0) and elsewhere, and the parameters with a non-finite
gradient; after the update, the parameters with a non-finite value or Adam
second moment. Imports nothing of JAX; run from the repo root on a machine
with one card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.config import AVQAConfig, AVSConfig, AVVPConfig, TrainConfig  # noqa: E402
from avmoe_tpu_torch.data.avqa import SyntheticAVQADataset  # noqa: E402
from avmoe_tpu_torch.data.avs import SyntheticAVSDataset  # noqa: E402
from avmoe_tpu_torch.data.avvp import SyntheticAVVPDataset  # noqa: E402
from avmoe_tpu_torch.data.loader import BatchLoader  # noqa: E402
from avmoe_tpu_torch.models.avqa import AVQAFusionModel, make_avqa_loss_fn  # noqa: E402
from avmoe_tpu_torch.models.avs import AVSModel, avs_frozen_scopes, make_avs_loss_fn  # noqa: E402
from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn  # noqa: E402
from avmoe_tpu_torch.train.loop import step_generator  # noqa: E402
from avmoe_tpu_torch.train.state import create_train_state  # noqa: E402

BATCH = 4
DEVICE = "cuda"
FIRST_SITE = ("encoder.audio_moe_p1_0.", "encoder.audio_moe_p2_0.")


def task(name: str):
    """(model factory, loss factory, dataset, seed, lr, frozen scopes) as the CLI sets them."""
    if name == "avvp":
        cfg = AVVPConfig()
        ds = SyntheticAVVPDataset(length=8 * BATCH, num_segments=cfg.num_segments,
                                  audio_len=cfg.audio_len, img_size=cfg.swin.img_size,
                                  st_dim=cfg.st_dim)
        return (lambda dt: MGNModel(cfg, dtype=dt, device=DEVICE, seed=23), make_avvp_loss_fn,
                ds, 23, 3e-4, ("swin", "htsat"))
    if name == "avqa":
        cfg = AVQAConfig()
        ds = SyntheticAVQADataset(length=8 * BATCH, num_segments=cfg.num_segments,
                                  audio_len=cfg.audio_len, img_size=cfg.swin.img_size,
                                  qst_vocab=cfg.qst_vocab, max_qst_len=cfg.max_qst_len,
                                  answer_vocab=cfg.answer_vocab)
        return (lambda dt: AVQAFusionModel(cfg, dtype=dt, device=DEVICE, seed=1),
                make_avqa_loss_fn, ds, 1, 1e-4, ("swin", "htsat"))
    cfg = AVSConfig()
    ds = SyntheticAVSDataset(length=4 * BATCH, num_segments=cfg.num_segments,
                             audio_len=cfg.audio_len, img_size=cfg.img_size,
                             mask_size=cfg.mask_size, setting="s4", split="train")
    return (lambda dt: AVSModel(cfg, dtype=dt, device=DEVICE, seed=0), make_avs_loss_fn, ds,
            0, 3e-4, avs_frozen_scopes(cfg))


@contextlib.contextmanager
def variant_env(kind: str):
    import avmoe_tpu_torch.ops.swin as swin

    kept = swin.window_attention, swin.mlp_block
    old = os.environ.get("AVMOE_DETERMINISTIC_TRAIN")
    if kind == "plain":
        swin.window_attention, swin.mlp_block = cs._plain_cores()
    if kind == "no specaugment":
        os.environ["AVMOE_DETERMINISTIC_TRAIN"] = "1"
    try:
        yield
    finally:
        swin.window_attention, swin.mlp_block = kept
        if old is None:
            os.environ.pop("AVMOE_DETERMINISTIC_TRAIN", None)
        else:
            os.environ["AVMOE_DETERMINISTIC_TRAIN"] = old


def run(name: str, kind: str) -> None:
    make_model, make_loss, ds, seed, lr, scopes = task(name)
    model = make_model(torch.float32 if kind == "float32" else torch.bfloat16)
    tcfg = TrainConfig(batch_size=BATCH, accum_steps=2, lr=lr, lr_mlp=lr, seed=seed)
    loader = BatchLoader(ds, BATCH, shuffle=True, num_workers=4, seed=seed, device=DEVICE)
    state = create_train_state(model, tcfg, len(loader), frozen_scopes=scopes)
    loss_fn = make_loss(model)
    gen = step_generator(seed, DEVICE)
    names = list(state.trainable)
    zero_var = []
    hook = model.encoder.htsat.patch_embed.register_forward_hook(
        lambda mod, args, out: zero_var.append(float(
            (out.detach().float().reshape(-1, out.shape[-1]).var(dim=-1) == 0).float().mean())))
    try:
        with variant_env(kind):
            for i, batch in enumerate(loader):
                if i == 3:
                    break
                zero_var.clear()
                loss, _ = loss_fn(model, batch, gen)
                grads = torch.autograd.grad(loss, list(state.trainable.values()),
                                            allow_unused=True)
                first = max((float(g.abs().max()) for n, g in zip(names, grads)
                             if g is not None and n.startswith(FIRST_SITE)), default=0.0)
                rest = max((float(g.abs().max()) for n, g in zip(names, grads)
                            if g is not None and not n.startswith(FIRST_SITE)), default=0.0)
                bad = [n for n, g in zip(names, grads)
                       if g is not None and not bool(torch.isfinite(g).all())]
                print(f"[{name} {kind}] micro-step {i + 1}: loss {float(loss):.5g}; HTS-AT patch "
                      f"tokens with zero variance {zero_var[0]:.4f}; max |grad| first audio site "
                      f"{first:.4g}, elsewhere {rest:.4g}; {len(bad)} non-finite gradients "
                      f"{bad[:4]}", flush=True)
                state.apply_gradients(grads)
                if state.mini_step == 0:
                    nan_p = [n for n, p in state.trainable.items()
                             if not bool(torch.isfinite(p).all())]
                    inf_v = [n for n, p in state.trainable.items()
                             if "exp_avg_sq" in state.optimizer.state[p] and not bool(
                                 torch.isfinite(state.optimizer.state[p]["exp_avg_sq"]).all())]
                    print(f"[{name} {kind}] after the update: {len(nan_p)} parameters non-finite "
                          f"{nan_p[:4]}; {len(inf_v)} with a non-finite Adam second moment "
                          f"{sorted({n.split('.')[1] for n in inf_v})[:6]}", flush=True)
    finally:
        hook.remove()
        del model, state
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", nargs="*", default=["avvp", "avqa", "avs"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cli_seed_init_grads.py needs a card")
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip(), flush=True)
    for name in args.tasks:
        for kind in ("bf16 kernels", "plain", "float32", "no specaugment"):
            run(name, kind)


if __name__ == "__main__":
    main()
