"""Where the AVS S4 step's bf16 gradients leave float32's, and whether the kernels do. (GPU)

    python3 tools/s4_grad_diagnosis.py [--seeds 12 13]

`AVSModel(AVSConfig())` with seeded weights and noised gates, as
chip_smoke.py builds it, one deterministic step (AVMOE_DETERMINISTIC_TRAIN=1,
mixup λ 0.6, batch 4 as chip_smoke.py's S4 batch; the generator seed sets
DropPath's and the routers' draws) in bf16:

1. The norm of the trainable gradients by group (HTS-AT, the audio and
   visual adapters, the rest), for each generator seed, with the attention
   and MLP cores as the kernels (K1 / K2 / K1b / K2b), as their plain
   versions (`chip_smoke._plain_cores`, float32 inside), or mixed, with
   HTS-AT trainable (S4's recipe) and frozen (MS3's scopes).
2. Every K1b and K2b call of the step at the first seed, at the inputs and
   output gradient the model gave it (captured by wrapping the cores): the
   kernels' gradients (dq, dk, dv, dbias; dx, d ln_w, d ln_b, dW1, db1,
   dW2, db2) against the float32 plain version's autograd of the same bf16
   inputs, as max |d| / (1 + max |ref|), the norm ratio and the cosine; the
   20 worst by the first and the 12 lowest cosines printed, with the
   reference's norm.

Imports nothing of JAX; run from the repo root on a machine with one card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.config import AVSConfig  # noqa: E402
from avmoe_tpu_torch.kernels.mlp_block import mlp_block, mlp_block_plain  # noqa: E402
from avmoe_tpu_torch.kernels.window_attention import (  # noqa: E402
    window_attention, window_attention_plain)
from avmoe_tpu_torch.models.avs import AVSModel, make_avs_loss_fn  # noqa: E402
from avmoe_tpu_torch.train.freeze import freeze  # noqa: E402

S4, MS3 = ("swin",), ("swin", "htsat")


def group_norms(grads) -> dict:
    out = {}
    for n, g in grads.items():
        key = ("htsat" if n.startswith("encoder.htsat") else "audio adapters"
               if "audio_moe" in n else "visual adapters" if "vis_moe" in n else "rest")
        out[key] = out.get(key, 0.0) + float(g.double().pow(2).sum())
    return {k: round(v ** 0.5, 4) for k, v in out.items()}


def capturing_cores(calls: list):
    """K1's and K2's wrappers, recording each call's inputs and output gradient."""

    def keep(out, rec):
        calls.append(rec)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("dout", g.detach().clone()))
        return out

    def attention(q, k, v, bias):
        return keep(window_attention(q, k, v, bias),
                    {"kind": "attn", "ins": [t.detach().clone() for t in (q, k, v, bias)]})

    def mlp(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm, eps=1e-5, scale=None, w1t=None,
            w2t=None):
        out = mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps, scale=scale,
                        w1t=w1t, w2t=w2t)
        return keep(out, {"kind": "mlp", "pre": pre_norm, "scale": scale,
                          "ins": [t.detach().clone() for t in (x, ln_w, ln_b, w1, b1, w2, b2)]})

    return attention, mlp


def check_call(rec):
    """[(name, max |d| / (1 + max |ref|), norm ratio, cosine)] of one captured call."""
    dout = rec["dout"].contiguous()
    if rec["kind"] == "attn":
        q, k, v, bias = rec["ins"]
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        got = torch.autograd.grad(window_attention(*leaves), leaves, dout)
        ref_in = [t.float().requires_grad_() for t in (q, k, v)] + [bias.clone().requires_grad_()]
        ref = torch.autograd.grad(window_attention_plain(*ref_in), ref_in, dout.float())
        names = ("dq", "dk", "dv", "dbias")
    else:
        x, *params = rec["ins"]
        leaves = [x.clone().requires_grad_()] + [t.clone().requires_grad_() for t in params]
        got = torch.autograd.grad(mlp_block(*leaves, pre_norm=rec["pre"], scale=rec["scale"]),
                                  leaves, dout)
        ref_in = [x.float().requires_grad_()] + [
            (t.to(x.dtype).float() if j in (2, 4) else t.clone()).requires_grad_()
            for j, t in enumerate(params)]
        ref = torch.autograd.grad(mlp_block_plain(*ref_in, pre_norm=rec["pre"],
                                                  scale=rec["scale"]), ref_in, dout.float())
        names = ("dx", "d ln_w", "d ln_b", "dW1", "db1", "dW2", "db2")
    rows = []
    for n, a, b in zip(names, got, ref):
        a, b = a.float(), b.float()
        rows.append((n, ((a - b).abs().max() / (1 + b.abs().max())).item(),
                     (a.norm() / b.norm().clamp_min(1e-30)).item(),
                     F.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item(),
                     b.norm().item()))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[12, 13])
    args = ap.parse_args()
    cs.phase_card()
    cfg = AVSConfig()
    src = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    cs._avs_noised_(src, 1)
    kept = {k: v.clone() for k, v in src.state_dict().items()}
    del src
    batch = cs._avs_batches(cfg, cs.BATCH, 1, 13, "cuda")[0]
    batch["mixup_lambda"] = torch.full_like(batch["mixup_lambda"], 0.6)
    plain_attn, plain_mlp = cs._plain_cores()
    variants = (("kernels", None, S4), ("K1 / K1b kernels, MLP plain", (window_attention,
                                                                         plain_mlp), S4),
                ("attention plain, K2 / K2b kernels", (plain_attn, mlp_block), S4),
                ("plain", (plain_attn, plain_mlp), S4),
                ("kernels, HTS-AT frozen", None, MS3), ("plain, HTS-AT frozen",
                                                        (plain_attn, plain_mlp), MS3))

    def model(scopes):
        m = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=None)
        m.load_state_dict(kept)
        freeze(m, scopes)
        return m

    for label, cores, scopes in variants:
        for seed in args.seeds:
            m = model(scopes)
            grads = cs._trainable_grads(m, make_avs_loss_fn(m), batch, seed, cores=cores)
            print(f"[s4 grads] bf16, {label}, seed {seed}: gradient norms {group_norms(grads)}",
                  flush=True)
            del m, grads
            torch.cuda.empty_cache()
    calls = []
    m = model(S4)
    cs._trainable_grads(m, make_avs_loss_fn(m), batch, args.seeds[0],
                        cores=capturing_cores(calls))
    rows = [(err, i, rec["kind"], name, tuple(rec["ins"][0].shape), ratio, cos, norm)
            for i, rec in enumerate(calls) if "dout" in rec
            for name, err, ratio, cos, norm in check_call(rec)]
    print(f"[s4 kernels] seed {args.seeds[0]}: {sum('dout' in r for r in calls)} of "
          f"{len(calls)} K1 / K2 calls had a gradient; their K1b / K2b outputs against the "
          f"float32 plain autograd of the same bf16 inputs, worst first:", flush=True)
    for label, worst in (("by max |d| / (1 + max |ref|)", sorted(rows, reverse=True)[:20]),
                         ("by cosine", sorted(rows, key=lambda r: r[6])[:12])):
        print(f"[s4 kernels] worst {label}:")
        for err, i, kind, name, shape, ratio, cos, norm in worst:
            print(f"[s4 kernels]   call {i} {kind} {shape} {name}: max |d| / (1 + max |ref|) "
                  f"{err:.3e}, norm ratio {ratio:.4f}, cosine {cos:.6f}, |ref| {norm:.3e}",
                  flush=True)
    print(f"[s4 kernels] over all {len(rows)} outputs: max |d| / (1 + max |ref|) "
          f"{max(r[0] for r in rows):.3e}, norm ratio {min(r[5] for r in rows):.4f} to "
          f"{max(r[5] for r in rows):.4f}, lowest cosine {min(r[6] for r in rows):.6f}")


if __name__ == "__main__":
    main()
