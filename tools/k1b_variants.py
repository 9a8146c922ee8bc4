"""Time the window-attention backward's (K1b's) bf16 kernel under variants.

    python3 tools/k1b_variants.py      # repo root, one NVIDIA GPU

Builds copies of `avmoe_tpu_torch/csrc/window_attention_bwd.cu`, each with
one text edit, in parallel, and times each copy's bf16 kernel (CUDA events)
at every K1b shape of the batch-4 AVE train step (chip_smoke.k1b_shapes).
Prints, per variant, the registers and spill bytes ptxas reports for its
tensor-core instantiations, the ms per shape and the ms per train step (each
shape times its launches). Every variant but the ablations is first
checked against the float32 plain autograd. The ablations compute wrong
results and only time what is left:

  no bias loads          S starts at 0: the N x N float32 bias is not read
  no dv, dk passes       steps 3 and 5 (the products read transposed from
                         the staged P and dS) run no iteration; zeros stored
  no dP, dq pass         step 4 runs no key chunk; dq stores zeros and the
                         staged P stands in for dS in step 5
  one CTA an SM          not an ablation: 116 KB more shared memory per CTA,
                         so one CTA holds an SM (9 warps at N=144)
  chunk loops unrolled   the key-chunk loop of step 4 and the row-tile loop
                         of steps 3 and 5 unrolled by 2 or 3 (more products
                         in flight per warp)

Builds go to avmoe_tpu_torch/_build/k1b_variants/.
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
from avmoe_tpu_torch.kernels.window_attention import (  # noqa: E402
    window_attention, window_attention_plain)

BIAS = ("    mma::load_logit_bias<2 * KT16>(s, bias + ((size_t)(bw % nW) * H + h) * N * N, "
        "nullptr, N,\n                                   r0, 2 * nkt16);")
NO_BIAS = ("#pragma unroll\n    for (int j = 0; j < 2 * KT16; ++j)\n#pragma unroll\n"
           "      for (int e = 0; e < 4; ++e) s[j][e] = 8 * j + 2 * t + (e & 1) < N ? 0.f : "
           "-INFINITY;")
PAD = 116 * 1024
ABLATIONS = ("no bias loads", "no dv, dk passes", "no dP, dq pass")
VARIANTS = {
    "kept kernel": [],
    "one CTA an SM": [
        ("kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_shared_bytes(KT16, KD));",
         f"kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         f"        (int)mma_shared_bytes(KT16, KD) + {PAD});"),
        ("mma_shared_bytes(nkt16, KD), stream>>>",
         f"mma_shared_bytes(nkt16, KD) + {PAD}, stream>>>")],
    "no bias loads": [(BIAS, NO_BIAS)],
    "no dv, dk passes": [
        ("xt_b<KD>(acc, Ps, ldp, r0, Gs, ld, nkt16, ndt8);",
         "xt_b<KD>(acc, Ps, ldp, r0, Gs, ld, 0, ndt8);"),
        ("xt_b<KD>(acc, Ps, ldp, r0, Qs, ld, nkt16, ndt8);",
         "xt_b<KD>(acc, Ps, ldp, r0, Qs, ld, 0, ndt8);")],
    "no dP, dq pass": [("for (int jc = 0; jc < nkt16; ++jc) {",
                        "for (int jc = 0; jc < 0; ++jc) {")],
    **{f"chunk loops unrolled by {u}": [
        ("    for (int jc = 0; jc < nkt16; ++jc) {",
         f"#pragma unroll {u}\n    for (int jc = 0; jc < nkt16; ++jc) {{"),
        ("  for (int it = 0; it < nkt16; ++it) {",
         f"#pragma unroll {u}\n  for (int it = 0; it < nkt16; ++it) {{")] for u in (2, 3)},
}


def build(out_dir: Path):
    src = (_build.CSRC_DIR / "window_attention_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in window_attention_bwd.cu")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cxxfilt = Path(_build.nvcc_path()).with_name("cu++filt")
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.window_attention_bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                                             + [ctypes.c_void_p])
        lib.window_attention_bwd.restype = ctypes.c_int
        report = ", ".join(f"{fn}: {r} regs / {st} B spilled"
                           for fn, r, st, _ in cs.ptxas_report(log, cxxfilt)
                           if "window_attention_bwd_mma_kernel" in fn)
        libs[name] = (lib, report)
    return libs


def backward(lib, q, k, v, bias, out, dout):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    BW, H, N, D = q.shape
    err = lib.window_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), 0, 0, BW, H, N, D, bias.shape[0], 1,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"window_attention_bwd failed: CUDA error {err}")
    return dq, dk, dv


def main():
    cs.phase_card()
    libs = build(_build.BUILD_DIR / "k1b_variants")
    for name, (_, report) in libs.items():
        print(f"[variant] {name}: {report}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {name: 0.0 for name in libs}
    for BW, H, N, D, nW, calls in cs.k1b_shapes(cs.BATCH * 10):
        q, k, v, do = (torch.randn(BW, H, N, D, device="cuda", generator=gen) * s
                       for s in (0.3, 0.3, 1.0, 1.0))
        bias = torch.randn(nW, H, N, N, device="cuda", generator=gen)
        _, ref = cs._grads(lambda a, b, c: window_attention_plain(a, b, c, bias),
                           [t.bfloat16().float() for t in (q, k, v)], do.bfloat16().float())
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        out = window_attention.forward_only(q, k, v, bias)
        row = []
        for name, (lib, _) in libs.items():
            if name not in ABLATIONS:
                for gname, a, b in zip("qkv", backward(lib, q, k, v, bias, out, do), ref):
                    cs.compare(a, b, torch.bfloat16, f"{name} {(BW, H, N, D, nW)} d{gname}")
            ms = cs.time_ms(lambda: backward(lib, q, k, v, bias, out, do))
            totals[name] += calls * ms
            row.append(f"{name} {ms:.4f}")
        print(f"[shape] BW,H,N,D,nW={(BW, H, N, D, nW)} x{calls}/step  ms: " + "; ".join(row),
              flush=True)
        del q, k, v, do, bias, out, ref
    for name, total in totals.items():
        print(f"[total] {name}: {total:.3f} ms per train step", flush=True)


if __name__ == "__main__":
    main()
