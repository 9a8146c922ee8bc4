"""K2b's bf16 bits in this checkout against an earlier commit's, on one GPU.

    python3 tools/k2b_bit_check.py --parent DIR

DIR holds an earlier commit's package (`git archive <commit> avmoe_tpu_torch
| tar -x -C DIR`; `_scratch/` is gitignored and goes to the chip). Each tree
runs, in a process of its own, the MLP block's bf16 forward and backward
through autograd (the calls a train step makes: K2, then K2b) at every
main-path shape of a batch-4 train step, both norms, with and without a
DropPath scale, on inputs made from one seed; the script compares the
SHA-256 of every output and input gradient and prints which differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(t) -> str:
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:20]


def digests(root: Path) -> dict:
    """{case: [sha of out, sha of dx]} with the package under `root`."""
    sys.path.insert(0, str(root))
    import torch

    from avmoe_tpu_torch.kernels import mlp_block as mb

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert Path(mb.__file__).resolve().is_relative_to(root.resolve()), mb.__file__
    frames = cs.BATCH * 10
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = (torch.rand(frames, device="cuda", generator=gen) >= 0.1).float() / 0.9
    scale[0] = 0.0
    out = {}
    for R, C, pre, _ in cs.k2b_shapes(frames):
        Hd, L = 4 * C, R // frames
        lw = 1.0 + 0.1 * torch.randn(C, device="cuda", generator=gen)
        lb = 0.1 * torch.randn(C, device="cuda", generator=gen)
        w1 = (torch.randn(Hd, C, device="cuda", generator=gen) / math.sqrt(C)).bfloat16()
        b1 = 0.1 * torch.randn(Hd, device="cuda", generator=gen)
        w2 = (torch.randn(C, Hd, device="cuda", generator=gen) / math.sqrt(Hd)).bfloat16()
        b2 = 0.1 * torch.randn(C, device="cuda", generator=gen)
        x = torch.randn(frames, L, C, device="cuda", generator=gen).bfloat16()
        dy = torch.randn(frames, L, C, device="cuda", generator=gen).bfloat16()
        for norm in (True, False):
            for sc in (None, scale):
                leaf = x.clone().requires_grad_()
                y = mb.mlp_block(leaf, lw, lb, w1, b1, w2, b2, pre_norm=norm, scale=sc)
                dx, = torch.autograd.grad(y, leaf, dy)
                key = f"R={R} C={C} {'v1' if norm else 'v2'} {'scaled' if sc is not None else ''}"
                out[key.strip()] = [_digest(y), _digest(dx)]
        torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="directory holding the earlier avmoe_tpu_torch")
    ap.add_argument("--digests-of", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.digests_of is not None:
        print(json.dumps(digests(args.digests_of)))
        return
    runs = {}
    for label, root in (("parent", args.parent), ("this checkout", ROOT)):
        res = subprocess.run([sys.executable, __file__, "--digests-of", str(root)],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            raise SystemExit(f"{label} failed:\n{res.stderr[-4000:]}")
        runs[label] = json.loads(res.stdout.strip().splitlines()[-1])
    a, b = runs["parent"], runs["this checkout"]
    same_out = [k for k in a if a[k][0] == b[k][0]]
    same_dx = [k for k in a if a[k][1] == b[k][1]]
    print(f"[k2b bits] {len(a)} cases (shape x norm x scale): forward out equal in "
          f"{len(same_out)}, dx equal in {len(same_dx)}")
    for k in a:
        if a[k] != b[k]:
            print(f"[k2b bits]   differs: {k}: out {'=' if a[k][0] == b[k][0] else '!='} "
                  f"dx {'=' if a[k][1] == b[k][1] else '!='}")


if __name__ == "__main__":
    main()
