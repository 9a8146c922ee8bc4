"""How reproducible are the AVE train step's trainable gradients? (GPU)

    python3 tools/train_grad_conditioning.py

One deterministic step (AVMOE_DETERMINISTIC_TRAIN=1, mixup λ given, batch 4
clips as chip_smoke.py builds it) of `AVEModel` with seeded weights, in
three cases: the full `AVEConfig()` with the adapter gates noised as
chip_smoke.py noises them, the same at the seeded init (gates zero, as the
flax initializers leave them), and both backbones cut to depths 2-2-2-2
with noised gates. For each case the cosine of the flattened trainable
gradients, overall and by parameter group:

  f32 plain / f32   the float32 model through the kernels' plain versions
                    against the float32 model through the kernels: the same
                    arithmetic in another rounding, so how far the gradient
                    is a well-conditioned function of the inputs;
  bf16 / f32        the bf16 model (kernels) against the float32 one;
  bf16 glue / f32   the bf16 model with the attention and MLP cores in
                    float32 (plain versions): what the bf16 PyTorch glue
                    alone does.

Imports nothing of JAX; run from the repo root on a machine with one card.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.config import AVEConfig  # noqa: E402
from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn  # noqa: E402
from avmoe_tpu_torch.train.freeze import freeze  # noqa: E402


def grads(model, batch, cores=None):
    """Trainable gradients of one deterministic step, by parameter name;
    `cores`: K1's and K2's plain versions in float32 in place of the kernels."""
    return cs._trainable_grads(model, make_ave_loss_fn(model), batch, 13, cores)


def group(name: str) -> str:
    parts = name.split(".")
    return parts[1].rsplit("_", 1)[0] if parts[0] == "encoder" else parts[0]


def cosines(a, b) -> str:
    groups = {}
    for n in b:
        groups.setdefault(group(n), []).append(n)
    cat = lambda g, names: torch.cat([g[n] for n in names]).double()
    out = [f"all {F.cosine_similarity(cat(a, b), cat(b, b), dim=0).item():.6f}"]
    out += [f"{k} {F.cosine_similarity(cat(a, v), cat(b, v), dim=0).item():.4f}"
            for k, v in groups.items()]
    return ", ".join(out)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_grad_conditioning: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_card()
    base = AVEConfig()
    cut = dataclasses.replace(base, swin=dataclasses.replace(base.swin, depths=(2, 2, 2, 2)),
                              htsat=dataclasses.replace(base.htsat, depths=(2, 2, 2, 2)))
    for label, cfg, noised in (("full depth, gates noised", base, True),
                               ("full depth, seeded init (gates zero)", base, False),
                               ("depths 2-2-2-2, gates noised", cut, True)):
        batch = cs._train_batches(cfg, cs.BATCH, 1, 11, "cuda")[0]
        m16 = AVEModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        if noised:
            cs._nonzero_gates_(m16, 1)
        m32 = AVEModel(cfg, dtype=torch.float32, device="cuda", seed=None)
        m32.load_state_dict(m16.state_dict())
        freeze(m16)
        freeze(m32)
        ref = grads(m32, batch)
        print(f"[{label}] f32 plain / f32: "
              f"{cosines(grads(m32, batch, cs._plain_cores()), ref)}", flush=True)
        print(f"[{label}] bf16 / f32: {cosines(grads(m16, batch), ref)}", flush=True)
        print(f"[{label}] bf16 glue / f32: "
              f"{cosines(grads(m16, batch, cs._plain_cores()), ref)}", flush=True)
        del m16, m32, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
