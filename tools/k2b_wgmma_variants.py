"""Time K2b's bf16 wgmma product under design variants and ablations.

    python3 tools/k2b_wgmma_variants.py [--only VARIANT ...]   # one NVIDIA GPU

Builds copies of `avmoe_tpu_torch/csrc/mlp_block.cu` with its product
header `gemm_wgmma.cuh`, each copy with one set of text edits of the
header's constants (producer warps, CTAs an SM, ring stages) or an
ablation, in parallel, and times each copy's product alone
(`mlp_block_gemm_wgmma`, CUDA events) at every K2b product of the batch-4
AVE train step (d_h1 = (g w2) gelu'(h1) [s], and dx = d_h1 w1 [+ dy]) at
each output tile width, beside cuBLAS's bf16 product of the same shape.
Prints per variant the registers and spill bytes ptxas reports for the
wgmma kernels, the ms per product and width, and per variant the products'
ms per train step at `pick_wgmma_tile`'s widths and at each product's
fastest width. Each copy but the ablations' is first checked against a
float32 product. Builds go to avmoe_tpu_torch/_build/k2b_variants/.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu_torch.kernels import _build  # noqa: E402
from avmoe_tpu_torch.kernels import mlp_block as mb  # noqa: E402

STAGES = ("  static constexpr int STAGES = (208 * 1024 - IO) / STAGE < 5 ? (208 * 1024 - IO) "
          "/ STAGE : 5;")
GELU_OUT = ("mlp_block.cu", "    return EPI == kEpiGeluGrad ? gelu_grad_fast(aux) : aux;",
            "    return aux;")
# variant -> [([file,] text in it, text of the variant)], the file
# gemm_wgmma.cuh unless named. The ablations compute wrong results: one
# moves no epilogue tile (no aux loads, no stores: the TMA copies stay
# behind a test that fails at run time), one multiplies by h1 instead of
# gelu'(h1)
ABLATIONS = ("no epilogue TMA loads or stores", "gelu'(h1) left out of the d_h1 epilogue")
VARIANTS = {
    "kept kernel": [],
    "3 stages at every width": [(STAGES, STAGES.split("= (")[0] + "= 3;")],
    "gelu'(h1) left out of the d_h1 epilogue": [GELU_OUT],
    "no epilogue TMA loads or stores": [
        ("        if (Epi::kReadsAux) {\n          const int boxes = min(BOXES, (N - n0 + "
         "kBoxN - 1) / kBoxN);\n          mbar_expect_tx(aux_full,",
         "        if (Epi::kReadsAux && M < 0) {\n          const int boxes = min(BOXES, (N - n0"
         " + kBoxN - 1) / kBoxN);\n          mbar_expect_tx(aux_full,"),
        ("          for (int b = 0; b < BOXES && prev_n0 + b * kBoxN < N; ++b)",
         "          for (int b = 0; b < BOXES && prev_n0 + b * kBoxN < N && M < 0; ++b)")],
}

# the kept kernel with time stamps (%globaltimer) per CTA: entry, barriers
# initialised; of its first tile: first stage landed, main loop retired, aux
# landed, epilogue written; its last tile's epilogue written; and the SM
TIMELINE = "kept kernel, time stamps"
_STAMP = """
__device__ unsigned long long g_stamp[4096 * 8];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (blockIdx.x >= 4096) return;
  g_stamp[blockIdx.x * 8 + i] = t;
  if (i == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamp[blockIdx.x * 8 + 7] = sm;
  }
}
"""
_INIT = ("    mbar_init(out_ready, kConsumerThreads);\n"
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
         "  }\n  __syncthreads();\n")
_DESC = ("        const uint64_t da = smem_desc(st + wr * 64 * kBK * 2), "
         "db = smem_desc(st + S::STAGE_A);\n")
VARIANTS[TIMELINE] = [
    ("using bf16 = __nv_bfloat16;\n", "using bf16 = __nv_bfloat16;\n" + _STAMP),
    ("  const int ntn = (N + BN - 1) / BN;\n",
     "  const int ntn = (N + BN - 1) / BN;\n  if (threadIdx.x == 0) stamp(0);\n"),
    (_INIT, _INIT + "  if (threadIdx.x == 0) stamp(1);\n"),
    (_DESC, _DESC + "        if (li == 0 && kt == 0 && threadIdx.x == 0) stamp(2);\n"),
    ("      fence_regs(d);\n",
     "      fence_regs(d);\n      if (li == 0 && threadIdx.x == 0) stamp(3);\n"),
    ("      mbar_wait(aux_full, li & 1);\n",
     "      mbar_wait(aux_full, li & 1);\n      if (li == 0 && threadIdx.x == 0) stamp(4);\n"),
    ("      mbar_arrive(out_ready);\n",
     "      mbar_arrive(out_ready);\n      if (threadIdx.x == 0) stamp(li == 0 ? 5 : 6);\n"),
    ("}  // namespace avmoe\n", "}  // namespace avmoe\n" + """
extern "C" int wg_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, avmoe::wg::g_stamp, sizeof(avmoe::wg::g_stamp));
}
""")]
ABLATIONS = ABLATIONS + (TIMELINE,)
PHASES = ("init", "first stage", "main loop", "aux wait", "epilogue", "the other tiles")


def pick(M: int, N: int, K: int, epi: int, sms: int) -> int:
    return mb.pick_wgmma_tile(M, N, K, sms, gelu=epi == mb.EPI_GELU_GRAD)


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores")


def wgmma_report(log: str) -> str:
    """Registers / spill-store bytes of the wgmma kernels, per width, and
    ptxas's warnings."""
    out, width = {}, None
    warn = sorted({ln.strip()[:160] for ln in log.splitlines() if "warning" in ln.lower()})
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            w = re.search(r"mlp_gemm_wgmmaILi(\d+)E", m.group(1))
            width = w.group(1) if w else None
        elif width and _SPILL.search(line):
            out.setdefault(width, set()).add(("spill", int(_SPILL.search(line).group(1))))
        elif width and _REGS.search(line):
            out.setdefault(width, set()).add(("regs", int(_REGS.search(line).group(1))))
    return ", ".join(f"{w}: " + " ".join(f"{k} {v}" for k, v in sorted(kv))
                     for w, kv in sorted(out.items())) + "".join(f"; {w}" for w in warn)


def build(out_dir: Path):
    files = ("gemm_wgmma.cuh", "mlp_block.cu")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        texts = {f: (_build.CSRC_DIR / f).read_text() for f in files}
        for edit in edits:
            f, old, new = edit if len(edit) == 3 else ("gemm_wgmma.cuh", *edit)
            if texts[f].count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in {f}")
            texts[f] = texts[f].replace(old, new)
        vdir = out_dir / f"v{i}"
        vdir.mkdir(exist_ok=True)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        so = vdir / "libv.so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so),
             str(vdir / "mlp_block.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.mlp_block_gemm_wgmma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                             + [ctypes.c_void_p])
        lib.mlp_block_gemm_wgmma.restype = ctypes.c_int
        libs[name] = (lib, wgmma_report(log))
    return libs


def product(lib, a, bt, epi, width, aux=None, scale=None):
    M = a.shape[0]
    out = torch.empty((M, bt.shape[0]), dtype=a.dtype, device=a.device)
    err = lib.mlp_block_gemm_wgmma(
        a.data_ptr(), bt.data_ptr(), 0 if aux is None else aux.data_ptr(), out.data_ptr(),
        0 if scale is None else scale.data_ptr(), 1 if scale is None else M // scale.shape[0],
        M, bt.shape[0], a.shape[1], epi, width, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"product failed: CUDA error {err}")
    return out


def timeline(lib, label, M, N, K, width, run):
    """Per-CTA phases of one call of the time-stamped kernel (medians over
    the CTAs; the first tile's phases, then the CTA's other tiles), the
    tiles a CTA ran and the call's span."""
    import numpy as np

    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (4096 * 8))()
    err = lib.wg_stamps(ctypes.byref(buf))
    if err:
        raise RuntimeError(f"stamps: CUDA error {err}")
    tiles = math.ceil(M / 128) * math.ceil(N / width)
    ctas = min(tiles, mb.sm_count(torch.cuda.current_device()))
    a = np.frombuffer(buf, dtype=np.uint64).reshape(4096, 8)[:ctas].astype(np.int64)
    a[:, 6] = np.where(a[:, 6] > 0, a[:, 6], a[:, 5])    # one tile: no later ones
    us = lambda x: float(np.median(x)) / 1e3
    parts = [us(a[:, i + 1] - a[:, i]) for i in range(6)]
    span = (a[:, 6].max() - a[:, 0].min()) / 1e3
    print(f"[timeline] {label} M={M} N={N} K={K} width {width}: {tiles} tiles on {ctas} CTAs "
          f"(up to {math.ceil(tiles / ctas)} a CTA); median per CTA, us: "
          + ", ".join(f"{p} {t:.2f}" for p, t in zip(PHASES, parts)) + f"; span {span:.2f} us",
          flush=True)


def products():
    """(label, M, N, K, epi, scaled, launches per train step) of every K2b product."""
    out = []
    for R, C, pre, calls in cs.k2b_shapes(cs.BATCH * 10):
        tag = f"{'v1' if pre else 'v2'} C={C}"
        out.append((f"{tag} d_h1", R, 4 * C, C, mb.EPI_GELU_GRAD, pre, calls))
        out.append((f"{tag} dx", R, C, 4 * C, mb.EPI_PLAIN if pre else mb.EPI_ADD, False, calls))
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=list(VARIANTS),
                    help="build and time this variant only (repeatable)")
    args = ap.parse_args()
    for name in set(VARIANTS) - set(args.only or VARIANTS):
        del VARIANTS[name]
    cs.phase_card()
    libs = build(_build.BUILD_DIR / "k2b_variants")
    sms = mb.sm_count(torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = cs.BATCH * 10
    scale = (torch.rand(frames, device="cuda", generator=gen) >= 0.1).float() / 0.9
    # one check per variant and width: a ragged (M, N, K), each epilogue
    a = torch.randn(1440, 392, device="cuda", generator=gen).bfloat16()
    bt = (torch.randn(200, 392, device="cuda", generator=gen) / 20).bfloat16()
    aux = torch.randn(1440, 200, device="cuda", generator=gen).bfloat16()
    v = a.float() @ bt.float().t()
    rows = scale.repeat_interleave(1440 // frames)[:, None]
    refs = {(mb.EPI_GELU_GRAD, True): v * mb.gelu_grad(aux.float()) * rows,
            (mb.EPI_ADD, False): v + aux.float(), (mb.EPI_PLAIN, False): v}
    for name, (lib, report) in list(libs.items()):
        print(f"[variant] {name}: {report}", flush=True)
        try:
            for (epi, scaled), r in refs.items() if name not in ABLATIONS else ():
                for width in mb.WGMMA_WIDTHS:
                    out = product(lib, a, bt, epi, width, None if epi == mb.EPI_PLAIN else aux,
                                  scale if scaled else None)
                    ok = bool(((out.float() - r).abs() <= 4e-3 * r.abs() + 1e-3).all())
                    cs.check(ok, f"{name} width {width} epi {epi} disagrees with float32")
        except (RuntimeError, AssertionError) as e:
            print(f"[variant] {name}: left out: {e}", flush=True)
            del libs[name]

    if TIMELINE in libs:
        lib = libs.pop(TIMELINE)[0]
        lib.wg_stamps.argtypes = [ctypes.c_void_p]
        for label, M, N, K, epi, scaled, calls in products():
            a = torch.randn(M, K, device="cuda", generator=gen).bfloat16()
            bt = (torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5).bfloat16()
            aux = None if epi == mb.EPI_PLAIN else torch.randn(M, N, device="cuda",
                                                               generator=gen).bfloat16()
            width = pick(M, N, K, epi, sms)
            timeline(lib, label, M, N, K, width, lambda: product(
                lib, a, bt, epi, width, aux, scale if scaled else None))
            del a, bt, aux

    picked = {name: 0.0 for name in libs}
    best = {name: 0.0 for name in libs}
    cublas = 0.0
    for label, M, N, K, epi, scaled, calls in products():
        a = torch.randn(M, K, device="cuda", generator=gen).bfloat16()
        bt = (torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5).bfloat16()
        aux = None if epi == mb.EPI_PLAIN else torch.randn(M, N, device="cuda",
                                                           generator=gen).bfloat16()
        sc = scale if scaled else None
        ops = 2 * M * N * K
        lib_ms = cs.time_ms(lambda: F.linear(a, bt))
        cublas += calls * lib_ms
        for name, (lib, _) in libs.items():
            row = {}
            for width in mb.WGMMA_WIDTHS:
                row[width] = cs.time_ms(lambda: product(lib, a, bt, epi, width, aux, sc))
            chosen = pick(M, N, K, epi, sms)
            picked[name] += calls * row[chosen]
            best[name] += calls * min(row.values())
            print(f"[product] {label} M={M} N={N} K={K} x{calls}/step (pick {chosen}, cuBLAS "
                  f"{lib_ms:.4f})  {name}: " + "; ".join(
                      f"{w}: {ms:.4f} ({ops / ms / 1e9:.0f} TFLOP/s)" for w, ms in row.items()),
                  flush=True)
        del a, bt, aux
    for name in libs:
        print(f"[total] {name}: products per train step, ms: at pick_wgmma_tile's widths "
              f"{picked[name]:.3f}, at each product's fastest width {best[name]:.3f}; cuBLAS "
              f"{cublas:.3f}", flush=True)


if __name__ == "__main__":
    main()
