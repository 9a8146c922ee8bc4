"""Where the block-chain kernel (K3) spends its time, phase by phase and
design step by design step.

    python3 tools/k3_phase_ablation.py [--parent DIR]   # repo root, one NVIDIA GPU

Builds copies of `avmoe_tpu_torch/csrc/block_chain.cu` with one phase
removed each (the tensor-core products, the attention, the LayerNorm /
residual rows, the products' epilogue stores, the cluster barriers), times
each copy on the chain path's geometries (bf16, batch 4, seeded blocks as in
chip_smoke.py), and prints the full kernel's time, the time each phase adds
(full minus the copy without it), the first CTA's time in each phase (from
clock64() stamps in another copy, at the device's reported clock), the
windows per cluster W and cluster size cs the kernel picks, the (window,
head) pairs its attention stages at once, and the clusters the card holds
at once per cluster size. The copies without a phase compute wrong results:
they serve only to time the phases.

It also times design variants, each at the kernel's pick of W and at one
window per cluster (`cluster_windows=1`): the attention on the CUDA cores
(the float32 chains' code) instead of TF32 mma.sync, two CTAs per SM (128
registers, 32-deep product stages) instead of one, and both. With
`--parent DIR` (a checkout of an earlier commit, for example unpacked with
`git archive <commit> avmoe_tpu_torch/csrc`) it times that commit's
block_chain.cu beside them. For each copy it prints the registers and spill
bytes ptxas reports for the bf16 kernel. Builds go to
avmoe_tpu_torch/_build/ablation/.
"""

from __future__ import annotations

import argparse
import ctypes
import re
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
    "products": ("  const int steps = mine * nk;", "  const int steps = 0 * mine * nk;"),
    "attention": ("  for (int i0 = 0; i0 < mine; i0 += p.S) {",
                  "  for (int i0 = 0; i0 < 0; i0 += p.S) {"),
    "rows": ("  for (int r = rank * kWarps + warp; r < M; r += p.cs * kWarps) {",
             "  for (int r = rank * kWarps + warp; r < 0; r += p.cs * kWarps) {"),
    # the stores stay in the program (behind a test that fails at run time),
    # so the compiler keeps the products whose results they store
    "epilogues": ("store_epi_pair<EPI>(out,", "if (Nout < 0) store_epi_pair<EPI>(out,"),
    "barriers": ("  cg::this_cluster().sync();", "  __syncthreads();"),
}
# design variants -> [(text in the source, text of the variant)]; timed
# beside the full kernel, not subtracted from it
CUDA_CORE_ATTENTION = [("  if constexpr (std::is_same<T, bf16>::value) {\n    if (p.C / p.nH <= 32)",
                        "  if constexpr (false) {\n    if (p.C / p.nH <= 32)")]
TWO_CTAS = [("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)"),
            ("constexpr int kBK = 64;", "constexpr int kBK = 32;"),
            ("constexpr size_t kSmemBf16 = 204 * 1024;", "constexpr size_t kSmemBf16 = 0;")]
VARIANTS = {
    "CUDA-core attention": CUDA_CORE_ATTENTION,
    "2 CTAs/SM": TWO_CTAS,
    "2 CTAs/SM + CUDA-core attention": TWO_CTAS + CUDA_CORE_ATTENTION,
}
# the timeline copy: the first CTA's clock64() where each phase starts (after
# the barrier that ends the phase before), and once more at the end
STAMP = "  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[stamp] = clock64();\n  ++stamp;\n"
STAMPED = (
    "  rows_phase<T>(p, rank, M, x, xs, nullptr,",
    "    gemm<T, kEpiF32>(h, M, C, qkvk",
    "    attention_phase<T>(p, k, rank, qkv, o, win0, nwin, smem);",
    "    gemm<T, kEpiF32>(o, M, C, projk",
    "    rows_phase<T>(p, rank, M, nullptr, xs, a, p.v2 ? n1s",
    "    gemm<T, kEpiGelu>(h, M, C, fc1k",
    "    gemm<T, kEpiF32>(hid, M, Hd, fc2k",
    "    rows_phase<T>(p, rank, M, nullptr, xs, a, p.v2 ? n2s",
)
KERNEL_END = "    cluster_barrier();\n  }\n}\n"


def replaced(src: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{what}: {old!r} is no longer in block_chain.cu")
        src = src.replace(old, new)
    return src


def timeline_source(src: str) -> str:
    for line in STAMPED + (KERNEL_END, "  const bool v1 = !p.v2;\n"):
        if src.count(line) != 1:
            raise RuntimeError(f"timeline: {line!r} is not once in block_chain.cu")
    for line in STAMPED:
        src = src.replace(line, STAMP + line)
    src = src.replace(KERNEL_END, "    cluster_barrier();\n  }\n" + STAMP + "}\n")
    src = src.replace("  const bool v1 = !p.v2;\n", "  const bool v1 = !p.v2;\n  int stamp = 0;\n")
    src = src.replace("using namespace avmoe;\n",
                      "using namespace avmoe;\n__device__ long long g_stamps[64];\n", 1)
    return src.replace("}  // namespace\n", """}  // namespace
extern "C" int block_chain_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * 64);
}
""", 1)


def phases(geom):
    """Phase names in the order the kernel stamps them."""
    block = ["qkv", "attention", "proj", "rows"] + (["fc1", "fc2", "rows"]
                                                     if geom.part == "full" else [])
    return ["rows"] + block * geom.K


# exported beside block_chain_fwd in the full kernel and the design variants:
# writes the picked W and cs, then the clusters held at once per cluster
# size 1 .. 8; returns the attention's pairs per stage (-1 on a CUDA error)
PICK = '''
extern "C" int block_chain_pick(const int* dim, int* picked) {
  Params p = {};
  p.G = dim[0]; p.N = dim[1]; p.C = dim[2]; p.nH = dim[3]; p.Hd = dim[4]; p.K = dim[5];
  p.nW = dim[6]; p.v2 = dim[7]; p.full = dim[8]; p.shifted = dim[9]; p.cs = 1; p.W = 1; p.S = 1;
  const size_t smem = shared_bytes(1, p.N, p.C / p.nH);
  if (cudaFuncSetAttribute(block_chain_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  for (int c = 1; c <= 8; ++c) {
    p.cs = c;
    if (max_active_clusters<bf16>(p, smem, picked + 1 + c) != cudaSuccess) return -1;
  }
  if (pick_cluster<bf16>(p, smem) != cudaSuccess) return -1;
  picked[0] = p.W;
  picked[1] = p.cs;
  return attention_pairs(smem, p.N, p.C / p.nH);
}
'''

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores")


def bf16_kernel_report(log: str) -> str:
    """Registers and spill-store bytes ptxas reports for the bf16 chain kernel."""
    regs = spill = "?"
    in_kernel = False
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            in_kernel = "block_chain_kernel" in m.group(1) and "bfloat16" in m.group(1)
        elif "Function properties for" in line:
            in_kernel = "block_chain_kernel" in line and "bfloat16" in line
        elif in_kernel and _SPILL.search(line):
            spill = _SPILL.search(line).group(1)
        elif in_kernel and _REGS.search(line):
            regs = _REGS.search(line).group(1)
    return f"{regs} registers, {spill} bytes spilled"


def build_variants(out_dir: Path, parent: Path | None):
    src = (_build.CSRC_DIR / "block_chain.cu").read_text()
    with_pick = lambda text: text.replace("}  // namespace\n", "}  // namespace\n" + PICK, 1)
    texts = {"full kernel": with_pick(src)}
    for phase, edit in REMOVALS.items():
        texts[f"no {phase}"] = replaced(src, [edit], f"phase {phase!r}")
    for name, edits in VARIANTS.items():
        texts[name] = with_pick(replaced(src, edits, f"variant {name!r}"))
    texts["timeline"] = timeline_source(src)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, text) in enumerate(texts.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        jobs.append((name, cu, _build.CSRC_DIR))
    if parent is not None:
        cu = parent / "avmoe_tpu_torch" / "csrc" / "block_chain.cu"
        jobs.append((f"parent ({parent.name})", cu, cu.parent))
    procs = []
    for i, (name, cu, inc) in enumerate(jobs):
        so = out_dir / f"libv{i}.so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(so), str(cu)],
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
        print(f"{name}: {bf16_kernel_report(log)}", flush=True)
    libs["timeline"].block_chain_stamps.argtypes = [ctypes.c_void_p]
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="checkout of an earlier commit whose block_chain.cu is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_phase_ablation: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants(_build.BUILD_DIR / "ablation", args.parent)
    designs = ["full kernel", *VARIANTS]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    load = bc._library
    clock_mhz = torch.cuda.get_device_properties(0).clock_rate / 1e3  # clock64() ticks per us
    # calls per forward of each chain and of its shifted twin, which has the
    # same phases and is timed as the unshifted one
    key = lambda g: (g.version, g.part, g.K, g.N, g.C)
    fwd_calls = {}
    for geom, calls in cs.k3_shapes():
        fwd_calls[key(geom)] = fwd_calls.get(key(geom), 0) + calls
    per_fwd, per_fwd_w1 = {}, {}
    for geom, calls in cs.k3_shapes():
        if geom.shifts[0]:
            continue
        G = cs.BATCH * 10 * geom.nW
        blocks = cs._chain_blocks(geom, gen)
        ops, _ = bc.stack_chain(blocks, geom.part, torch.bfloat16)
        xw = torch.randn(G, geom.N, geom.C, device="cuda", generator=gen).bfloat16()
        dims = [G, geom.N, geom.C, geom.num_heads, geom.mlp_hidden, geom.K, geom.nW,
                int(geom.version == "v2"), int(geom.part == "full"), 0]
        dim_arr = (ctypes.c_int * len(dims))(*dims)
        picks = {}
        for name in designs:
            picked = (ctypes.c_int * 10)()
            pairs = libs[name].block_chain_pick(dim_arr, picked)
            if pairs < 0:
                raise RuntimeError(f"{name}: the cluster pick failed with a CUDA error")
            picks[name] = (picked[0], picked[1], pairs, list(picked[2:]))
        times, times_w1 = {}, {}
        try:
            for name, lib in libs.items():
                bc._library = lambda lib=lib: lib
                times[name] = cs.time_ms(lambda: bc.block_chain.windows(xw, ops, geom))
                if name in designs:
                    times_w1[name] = cs.time_ms(
                        lambda: bc.block_chain.windows(xw, ops, geom, cluster_windows=1))
        finally:
            bc._library = load
        for name, t in times.items():
            per_fwd[name] = per_fwd.get(name, 0.0) + t * fwd_calls[key(geom)]
        for name, t in times_w1.items():
            per_fwd_w1[name] = per_fwd_w1.get(name, 0.0) + t * fwd_calls[key(geom)]
        full = times["full kernel"]
        # the timeline copy's stamps of its last (timed) launch
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 64)()
        libs["timeline"].block_chain_stamps(stamps)
        per = {}
        for i, name in enumerate(phases(geom)):
            per[name] = per.get(name, 0.0) + (stamps[i + 1] - stamps[i]) / clock_mhz
        w, c, pairs, held = picks["full kernel"]
        print(f"{geom.version} {geom.part} K={geom.K} G={G} N={geom.N} C={geom.C} x{calls}/fwd; "
              "clusters held per size " + " ".join(f"{i + 1}:{n}" for i, n in enumerate(held))
              + f"; picked W={w} cs={c}, attention pairs per stage {pairs}; "
              f"full kernel {full:.3f} ms; " + ", ".join(
                  f"{name[3:]} {full - t:.3f} ms" for name, t in times.items()
                  if name.startswith("no ")), flush=True)
        print("  designs, ms at the pick (W, cs) / at W=1: " + "; ".join(
            f"{name} {times[name]:.3f} (W={picks[name][0]}, cs={picks[name][1]}) / "
            f"{times_w1[name]:.3f}" for name in designs) + "".join(
            f"; {name} {t:.3f}" for name, t in times.items() if name.startswith("parent")),
            flush=True)
        print("  first CTA, us by phase (each up to the barrier that ends it): " + ", ".join(
            f"{name} {us:.1f}" for name, us in per.items()) + f"; total {sum(per.values()):.1f}",
            flush=True)
    print("per batch-4 forward, ms at the pick / at W=1 (shifted chains at their unshifted "
          "twin's time): " + "; ".join(
              f"{name} {per_fwd[name]:.3f} / {per_fwd_w1[name]:.3f}" for name in designs)
          + "".join(f"; {name} {t:.3f}" for name, t in per_fwd.items()
                    if name.startswith("parent")), flush=True)


if __name__ == "__main__":
    main()
