"""Where a legacy AVE model's train-step gradients grow, block by block, and
which parameters Adam leaves in place. (GPU)

    python3 tools/legacy_grad_diagnosis.py [--models lavish v1] [--steps 3]

Each model as `chip_smoke.py` `phase_legacy` builds and trains it: full
width (`AVEConfig()`), bf16, seed 0 with noised gates and gate_av
(`_nonzero_gates_`), its batch-4 train batch and step generator, in four
variants:

  * bf16 through the kernels (K1 / K2 / K1b / K2b): what the phase runs;
  * bf16 through the kernels' plain versions in float32 (`_plain_cores`);
  * float32 through the kernels;
  * bf16 through the kernels with AVMOE_DETERMINISTIC_TRAIN=1.

Per variant: one step's loss; the largest |gradient| of each stream at the
output of every sub-block (`models/ave_legacy.py` `attn_state` /
`mlp_state`) and of every adapter's residual, from the loss back to the
first block; the trainable parameters whose gradient is not finite or
above 1.8e19 (its square overflows Adam's float32 second moment); then
`--steps` Adam steps (accum 1) and the parameters that stayed bit-identical
or whose second moment is not finite. Imports nothing of JAX; run from the
repo root on a machine with one card.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import avmoe_tpu_torch.models.ave_legacy as al  # noqa: E402
from avmoe_tpu_torch.config import AVEConfig, TrainConfig  # noqa: E402
from avmoe_tpu_torch.train.freeze import freeze  # noqa: E402
from avmoe_tpu_torch.train.state import create_train_state  # noqa: E402
from avmoe_tpu_torch.train.steps import make_train_step  # noqa: E402

OVERFLOW = 1.8e19          # above this a float32 square is inf


@contextlib.contextmanager
def _stream_grads(rows):
    """Record (sub-block, its output's largest |grad|) as the backward
    reaches each sub-block output."""
    kept = al.attn_state, al.mlp_state

    def wrap(fn, name):
        def run(blk, x, dt, train, generator):
            out = fn(blk, x, dt, train, generator)
            if out.requires_grad:
                i = len(rows)
                rows.append([name, tuple(out.shape), None])
                out.register_hook(lambda g, i=i: rows[i].__setitem__(
                    2, float(g.float().abs().max())))
            return out
        return run

    al.attn_state, al.mlp_state = wrap(kept[0], "attn"), wrap(kept[1], "mlp")
    try:
        yield rows
    finally:
        al.attn_state, al.mlp_state = kept


def _model(name: str, dtype):
    cfg = AVEConfig()
    model = getattr(al, cs.LEGACY[name])(cfg, dtype=dtype, device="cuda", seed=0)
    cs._nonzero_gates_(model, 1)
    return cfg, model


def _batch(cfg, name: str):
    batch = cs._train_batches(cfg, cs.BATCH, 1, 11, "cuda")[0]
    batch.pop("mixup_lambda")
    if name == "lavish":
        batch["audio_spec"] = cs._legacy_inputs(cfg, name, 4)[0]
        batch.pop("wave")
    return batch


def _loss_fn(name: str, model):
    return (al.make_mmil_v1_loss_fn(model, mixup_alpha=0.5) if name == "v1"
            else al.make_mmil_v2_loss_fn(model))


def one_step(name: str, dtype, cores=None, deterministic: bool = False):
    cfg, model = _model(name, dtype)
    freeze(model)
    batch = _batch(cfg, name)
    rows = []
    import avmoe_tpu_torch.ops.swin as swin

    kept = swin.window_attention, swin.mlp_block
    if cores is not None:
        swin.window_attention, swin.mlp_block = cores
    env = cs._deterministic() if deterministic else contextlib.nullcontext()
    try:
        with env, _stream_grads(rows):
            gen = torch.Generator(device="cuda").manual_seed(12)
            loss, _ = _loss_fn(name, model)(model, batch, gen)
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    finally:
        swin.window_attention, swin.mlp_block = kept
    big = {n: float(g.float().abs().max()) for (n, _), g in zip(named, grads)
           if g is not None and (not bool(torch.isfinite(g).all())
                                 or float(g.float().abs().max()) > OVERFLOW)}
    top = max(((float(g.float().abs().max()), n) for (n, _), g in zip(named, grads)
               if g is not None), default=(0.0, ""))
    return float(loss), rows, big, top


def steps(name: str, n: int):
    cfg, model = _model(name, torch.bfloat16)
    state = create_train_state(model, TrainConfig(accum_steps=1), steps_per_epoch=100)
    step = make_train_step(_loss_fn(name, model))
    batch = _batch(cfg, name)
    gen = torch.Generator(device="cuda").manual_seed(12)
    start = {k: p.detach().clone() for k, p in state.trainable.items()}
    losses = []
    for _ in range(n):
        state, met = step(state, batch, gen)
        losses.append(float(met["loss"]))
    still = sorted(k for k, p in state.trainable.items() if torch.equal(p, start[k]))
    inf_v = sorted(k for k, p in state.trainable.items()
                   if not bool(torch.isfinite(state.optimizer.state[p]["exp_avg_sq"]).all()))
    return losses, still, inf_v


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--models", nargs="+", default=["lavish", "v1"], choices=sorted(cs.LEGACY))
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args()
    cs.phase_card()
    for name in args.models:
        variants = (("bf16 kernels", torch.bfloat16, None, False),
                    ("bf16 plain cores", torch.bfloat16, cs._plain_cores(), False),
                    ("float32 kernels", torch.float32, None, False),
                    ("bf16 kernels, deterministic", torch.bfloat16, None, True))
        for label, dtype, cores, det in variants:
            loss, rows, big, top = one_step(name, dtype, cores, det)
            print(f"[{name}] {label}: loss {loss:.5f}; largest |grad| {top[0]:.3e} ({top[1]}); "
                  f"{len(big)} parameters with a gradient not finite or > {OVERFLOW:.1e}: "
                  f"{sorted(big)[:8]}")
            # the backward visits the sub-blocks last to first
            line = ", ".join(f"{i}:{r[0]}{r[1][1]}x{r[1][2]} {r[2]:.2e}"
                             for i, r in enumerate(rows) if r[2] is not None
                             and (i < 8 or i % 4 == 0 or not math.isfinite(r[2])))
            print(f"[{name}] {label}: stream |grad| max at sub-block outputs (forward order): "
                  f"{line}")
            torch.cuda.empty_cache()
        losses, still, inf_v = steps(name, args.steps)
        print(f"[{name}] bf16 kernels, {args.steps} Adam steps: losses "
              f"{[round(x, 5) for x in losses]}; {len(still)} trainable tensors bit-identical "
              f"{still[:12]}; {len(inf_v)} with a non-finite second moment {inf_v[:12]}")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
