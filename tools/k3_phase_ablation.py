"""Where the block-chain kernel (K3) spends its time, phase by phase.

    python3 tools/k3_phase_ablation.py        # from the repo root, one NVIDIA GPU

Builds copies of `avmoe_tpu_torch/csrc/block_chain.cu` with one phase
removed each (the products, the attention, the LayerNorm / residual rows,
the products' epilogues, the cluster barriers), times each copy on the
chain path's geometries (bf16, batch 4, seeded blocks as in chip_smoke.py),
and prints the full kernel's time, the time each phase adds (full minus the
copy without it), the cluster size the kernel picks and the clusters the
card holds at once per cluster size. The copies compute wrong results: they
serve only to time the phases. Builds go to avmoe_tpu_torch/_build/ablation/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.kernels import _build  # noqa: E402
from avmoe_tpu_torch.kernels import block_chain as bc  # noqa: E402

# phase -> (text in the source, text that removes the phase)
REMOVALS = {
    "products": ("  for (int t = rank; t < ntiles; t += cs) {",
                 "  for (int t = rank; t < 0; t += cs) {"),
    "attention": ("  for (int hh = rank; hh < nH; hh += p.cs) {",
                  "  for (int hh = rank; hh < 0; hh += p.cs) {"),
    "rows": ("  for (int r = rank * kWarps + warp; r < p.N; r += p.cs * kWarps) {",
             "  for (int r = rank * kWarps + warp; r < 0; r += p.cs * kWarps) {"),
    "epilogues": ("          for (int e = lane; e < 256; e += 32) {",
                  "          for (int e = lane; e < 0; e += 32) {"),
    "barriers": ("  cg::this_cluster().sync();", "  __syncthreads();"),
}
# exported beside block_chain_fwd in the unmodified copy
PICK = '''
#include <stdio.h>
extern "C" int block_chain_pick(const int* dim) {
  Params p = {};
  p.G = dim[0]; p.N = dim[1]; p.C = dim[2]; p.nH = dim[3]; p.Hd = dim[4]; p.K = dim[5];
  p.nW = dim[6]; p.v2 = dim[7]; p.full = dim[8]; p.shifted = dim[9]; p.cs = 1;
  const size_t smem = shared_bytes(1, p.N, p.C / p.nH);
  cudaFuncSetAttribute(block_chain_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  for (int c = 1; c <= 8; ++c) {
    p.cs = c;
    printf("%d:%d ", c, max_active_clusters<bf16>(p, smem));
  }
  p.cs = 1;
  return pick_cluster<bf16>(p, smem);
}
'''


def build_variants(out_dir: Path):
    src = (_build.CSRC_DIR / "block_chain.cu").read_text()
    src = src.replace('#include "common.cuh"', f'#include "{_build.CSRC_DIR / "common.cuh"}"')
    texts = {"full kernel": src.replace("}  // namespace\n", "}  // namespace\n" + PICK, 1)}
    for phase, (old, new) in REMOVALS.items():
        if old not in src:
            raise RuntimeError(f"phase {phase!r}: {old!r} is no longer in block_chain.cu")
        texts[f"no {phase}"] = src.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, text) in enumerate(texts.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.block_chain_fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p]
        lib.block_chain_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k3_phase_ablation: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants(_build.BUILD_DIR / "ablation")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    load = bc._library
    for geom, calls in cs.k3_shapes():
        if geom.shifts[0]:
            continue                      # the unshifted twin has the same phases
        G = cs.BATCH * 10 * geom.nW
        blocks = cs._chain_blocks(geom, gen)
        ops, _ = bc.stack_chain(blocks, geom.part, torch.bfloat16)
        xw = torch.randn(G, geom.N, geom.C, device="cuda", generator=gen).bfloat16()
        dims = [G, geom.N, geom.C, geom.num_heads, geom.mlp_hidden, geom.K, geom.nW,
                int(geom.version == "v2"), int(geom.part == "full"), 0]
        print(f"{geom.version} {geom.part} K={geom.K} G={G} N={geom.N} C={geom.C} "
              f"x{calls}/fwd; clusters held per size ", end="", flush=True)
        picked = libs["full kernel"].block_chain_pick((ctypes.c_int * len(dims))(*dims))
        times = {}
        try:
            for name, lib in libs.items():
                bc._library = lambda lib=lib: lib
                times[name] = cs.time_ms(lambda: bc.block_chain.windows(xw, ops, geom))
        finally:
            bc._library = load
        full = times["full kernel"]
        print(f"; picked cs={picked}; full kernel {full:.3f} ms; " + ", ".join(
            f"{name[3:]} {full - t:.3f} ms" for name, t in times.items() if name != "full kernel"),
            flush=True)


if __name__ == "__main__":
    main()
