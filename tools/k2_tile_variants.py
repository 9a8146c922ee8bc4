"""Time the MLP-block kernel's (K2's) bf16 product under design variants.

    python3 tools/k2_tile_variants.py      # repo root, one NVIDIA GPU

Builds copies of `avmoe_tpu_torch/csrc/mlp_block.cu`, each with one text
edit of the product kernel's tile constants (k-step depth, ring stages,
warps and warp tiles), in parallel, and times each copy's product alone
(`mlp_block_gemm_bf16`, CUDA events) at every main-path product of the
batch-4 AVE forward (fc1 with its GELU, fc2 with + b2, and + x on the V1
blocks), at each output tile width. Prints, per variant, the registers and
spill bytes ptxas reports for its kernels, the CTAs per SM, the ms per
product and width, and per width the products' ms per forward (each shape
times its calls); each copy's output but the ablations' is first checked against a
float32 product. Builds go to avmoe_tpu_torch/_build/k2_variants/.
"""

from __future__ import annotations

import ctypes
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
from avmoe_tpu_torch.kernels.mlp_block import TILE_WIDTHS, pick_tile, sm_count  # noqa: E402

DEPTH = "constexpr int kBK = 64, kLd = kBK + 8, kStages = 3;"
WIDE = "template <> struct TileShape<128> : Tile<2, 4, 4, 4> {};"
BOUNDS = "__launch_bounds__(TileShape<BN>::THREADS, 2)"
ONE_CTA = [(BOUNDS, BOUNDS.replace(", 2)", ", 1)"))]
# variant -> [(text in the source, text of the variant)]. The two ablations
# ("no copies ...", "no stores") compute wrong results and only time the
# main loop without its global loads / the kernel without its epilogue
# stores (the stores stay behind a test that fails at run time, so the
# compiler keeps the products).
ABLATIONS = ("no copies past the ring's first fill", "no stores", "no GELU")
VARIANTS = {
    "kept kernel": [],
    "no copies past the ring's first fill": [
        ("    if (next < nk) load(next % kStages, next);",
         "    if (next < nk && next < kStages) load(next % kStages, next);")],
    "no stores": [("    *reinterpret_cast<uint4*>(C + idx) = o;",
                   "    if (idx > (size_t)1 << 62) *reinterpret_cast<uint4*>(C + idx) = o;")],
    "no GELU": [("  return EPI == kEpiGelu ? gelu_erf(v) : v;", "  return v;")],
    "32-deep steps, 4 stages": [(DEPTH, DEPTH.replace("kBK = 64", "kBK = 32")
                                 .replace("kStages = 3", "kStages = 4"))],
    "128-wide: 4 warps of 64 x 64": [(WIDE, WIDE.replace("<2, 4, 4, 4>", "<2, 2, 4, 8>"))],
    "128-wide, 256 rows: 16 warps of 64 x 32, 1 CTA/SM": [
        (WIDE, WIDE.replace("<2, 4, 4, 4>", "<4, 4, 4, 4>"))] + ONE_CTA,
    "128-wide, 256 rows: 8 warps of 64 x 64, 1 CTA/SM": [
        (WIDE, WIDE.replace("<2, 4, 4, 4>", "<4, 2, 4, 8>"))] + ONE_CTA,
}

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores")


def gemm_report(log: str) -> str:
    """Registers / spill-store bytes of the bf16 product kernel, per width."""
    out, width = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            w = re.search(r"mlp_gemm_bf16ILi(\d+)ELi1E", m.group(1))
            width = w.group(1) if w else None
        elif width and _SPILL.search(line):
            out.setdefault(width, [None, None])[1] = _SPILL.search(line).group(1)
        elif width and _REGS.search(line):
            out.setdefault(width, [None, None])[0] = _REGS.search(line).group(1)
    return ", ".join(f"{w}: {r} regs / {s} B spilled" for w, (r, s) in sorted(out.items()))


def build(out_dir: Path):
    src = (_build.CSRC_DIR / "mlp_block.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in mlp_block.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.mlp_block_gemm_bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p])
        lib.mlp_block_gemm_bf16.restype = ctypes.c_int
        lib.mlp_block_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_void_p]
        libs[name] = (lib, gemm_report(log))
    return libs


def product(lib, a, w, bias, epi, width, resid=None):
    out = torch.empty((a.shape[0], w.shape[0]), dtype=a.dtype, device=a.device)
    err = lib.mlp_block_gemm_bf16(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                  0 if resid is None else resid.data_ptr(), out.data_ptr(),
                                  0, 0, 1, a.shape[0], w.shape[0], a.shape[1], epi, width,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"product failed: CUDA error {err}")
    return out


def products():
    """(label, M, N, K, epi, calls per forward) of every main-path product."""
    out = []
    for R, C, pre, calls in cs.k2_shapes(cs.BATCH * 10):
        tag = f"{'v1' if pre else 'v2'} C={C}"
        out.append((f"{tag} fc1", R, 4 * C, C, 1, calls))
        out.append((f"{tag} fc2", R, C, 4 * C, 2 if pre else 0, calls))
    return out


def main():
    cs.phase_card()
    libs = build(_build.BUILD_DIR / "k2_variants")
    sms = sm_count(torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(0)
    # one check per variant and width: a ragged (M, N, K), each epilogue
    a = torch.randn(1000, 392, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(200, 392, device="cuda", generator=gen) / 20).bfloat16()
    bias = 0.1 * torch.randn(200, device="cuda", generator=gen)
    resid = torch.randn(1000, 200, device="cuda", generator=gen).bfloat16()
    ref = a.float() @ w.float().t() + bias
    refs = {0: ref, 1: F.gelu(ref), 2: ref + resid.float()}
    for name, (lib, report) in libs.items():
        for width in TILE_WIDTHS if name not in ABLATIONS else ():
            for epi, r in refs.items():
                out = product(lib, a, w, bias, epi, width, resid)
                ok = bool(((out.float() - r).abs() <= 2e-2 * (1 + r.abs())).all())
                cs.check(ok, f"{name} width {width} epi {epi} disagrees with float32")
        ctas = []
        for width in TILE_WIDTHS:
            n = ctypes.c_int(0)
            lib.mlp_block_ctas_per_sm(width, ctypes.byref(n))
            ctas.append(f"{width}: {n.value}")
        print(f"[variant] {name}: {report}; CTAs per SM {', '.join(ctas)}", flush=True)

    totals = {name: {w: 0.0 for w in TILE_WIDTHS} for name in libs}
    picked = {name: 0.0 for name in libs}
    for label, M, N, K, epi, calls in products():
        a = torch.randn(M, K, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(N, K, device="cuda", generator=gen) / K ** 0.5).bfloat16()
        bias = 0.1 * torch.randn(N, device="cuda", generator=gen)
        resid = torch.randn(M, N, device="cuda", generator=gen).bfloat16() if epi == 2 else None
        ops = 2 * M * N * K
        for name, (lib, _) in libs.items():
            row = []
            for width in TILE_WIDTHS:
                ms = cs.time_ms(lambda: product(lib, a, w, bias, epi, width, resid))
                totals[name][width] += calls * ms
                if width == pick_tile(M, N, K, sms):
                    picked[name] += calls * ms
                row.append(f"{width}: {ms:.4f} ({ops / ms / 1e9:.0f} TFLOP/s)")
            print(f"[product] {label} M={M} N={N} K={K} x{calls}/fwd  {name}: "
                  + "; ".join(row), flush=True)
        del a, w, resid
    for name in libs:
        print(f"[total] {name}: products per forward, ms, by width: "
              + ", ".join(f"{w}: {t:.3f}" for w, t in totals[name].items())
              + f"; at pick_tile's widths: {picked[name]:.3f}", flush=True)


if __name__ == "__main__":
    main()
