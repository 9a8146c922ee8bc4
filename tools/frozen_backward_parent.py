"""K1b's and K2b's frozen path in this checkout against an earlier commit's, on one GPU.

    python3 tools/frozen_backward_parent.py --parent DIR

DIR holds an earlier commit's package (`git archive <commit> avmoe_tpu_torch
| tar -x -C DIR`; `_scratch/` is gitignored and goes to the chip). The
backward kernels take a frozen branch (no bias or weight gradient) in every
train step but AVS S4's. Each tree runs, in a process of its own and in
turns (parent, this, this, parent), K1b and K2b in bf16 at every shape of a
batch-4 AVE train step (`chip_smoke.k1b_shapes`, `k2b_shapes`; K2b with the
step's DropPath scale) on inputs made from one seed: the SHA-256 of K1b's
dq, dk, dv and K2b's dx, and their time per train step (CUDA events,
`chip_smoke.time_ms`, summed over the step's calls). It prints whether the
bits match and the four times of each kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:20]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from avmoe_tpu_torch.kernels import mlp_block as mb
    from avmoe_tpu_torch.kernels import window_attention as wa

    assert Path(wa.__file__).resolve().is_relative_to(root.resolve()), wa.__file__
    frames = cs.BATCH * 10
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits, times = {}, {"K1b": 0.0, "K2b": 0.0}
    for BW, H, N, D, nW, calls in cs.k1b_shapes(frames):
        q, k, v, do = (torch.randn(BW, H, N, D, device="cuda", generator=gen).bfloat16()
                       for _ in range(4))
        bias = torch.randn(nW, H, N, N, device="cuda", generator=gen)
        out = wa.window_attention.forward_only(q, k, v, bias)
        grads = wa.window_attention_bwd(q, k, v, bias, out, do)
        bits[f"K1b {(BW, H, N, D, nW)}"] = [_digest(g) for g in grads]
        times["K1b"] += calls * cs.time_ms(lambda: wa.window_attention_bwd(q, k, v, bias, out,
                                                                            do))
    scale = (torch.rand(frames, device="cuda", generator=gen) >= 0.1).float() / 0.9
    scale[0] = 0.0
    for R, C, pre, calls in cs.k2b_shapes(frames):
        lw, lb, w1, b1, w2, b2 = cs._mlp_weights(C, gen)
        W1, W2 = w1.bfloat16(), w2.bfloat16()
        W1t, W2t = W1.t().contiguous(), W2.t().contiguous()
        x = torch.randn(frames, R // frames, C, device="cuda", generator=gen).bfloat16()
        dy = torch.randn(frames, R // frames, C, device="cuda", generator=gen).bfloat16()
        _, h1, f = mb.mlp_block.forward_only(x, lw, lb, W1, b1, W2, b2, pre_norm=pre,
                                             scale=scale, keep=True)
        src = x if pre else f
        bwd = lambda: mb.mlp_block_bwd(dy, h1, src, lw, W1t, W2t, pre_norm=pre, scale=scale)
        bits[f"K2b {(R, C, pre)}"] = [_digest(bwd())]
        times["K2b"] += calls * cs.time_ms(bwd)
    return {"bits": bits, "times": times}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker))), flush=True)
        return
    parent = Path(args.parent).resolve()
    runs = []
    for label, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                             capture_output=True, text=True, check=True, timeout=900).stdout
        runs.append((label, json.loads(out.strip().splitlines()[-1])))
    same = all(r["bits"] == runs[0][1]["bits"] for _, r in runs)
    differ = [k for k in runs[0][1]["bits"] if runs[0][1]["bits"][k] != runs[1][1]["bits"][k]]
    print(f"[frozen backward] bits of K1b's dq, dk, dv and K2b's dx at "
          f"{len(runs[0][1]['bits'])} shapes: {'identical' if same else 'DIFFER'} across the "
          f"four runs" + (f"; parent vs this differ at {differ}" if differ else ""))
    for k in ("K1b", "K2b"):
        print(f"[frozen backward] {k} ms per AVE train step, in turns: " + ", ".join(
            f"{label} {r['times'][k]:.4f}" for label, r in runs))
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()
