"""K3: a chain of K consecutive Swin blocks of one (window, shift).

Replaces the TPU kernel `fused_block_chain` (experiments/pallas/fused_block.py
:237; body `_chain_kernel` :191, `_attn_sub` :121, `_mlp_sub` :176; operands
`stack_chain` :404; grouping `run_chain` :479, `_chain_groups` :507). The
CUDA kernel is `csrc/block_chain.cu`: one launch runs both sub-blocks of all
K blocks over windowed tokens. `block_chain_plain` below is the Pallas body
in plain PyTorch, rounding to the compute type where it rounds; the wrapper
takes it only for tensors on the CPU. (In bf16 the kernel rounds in fewer
places than the Pallas body: see the note in csrc/block_chain.cu.)

  stack_chain(blocks, part, dtype)  operands + ChainGeom from the port's SwinBlocks
  chain_groups(items, key)          maximal runs of one (window, shift)
  block_chain(x, ops, geom)         flat tokens (B, H*W, C): roll + window
                                    partition, the kernel, reverse; part 'mlp'
                                    goes to K2 (`mlp_block`) per block
  block_chain.windows(xw, ops, geom)  the kernel on windowed tokens (G, N, C)
  run_chain(blocks, x, part)        group, stack and run a block list

Operands (the JAX `stack_chain` layout; weights in the compute dtype, the
bias table and logit scale float32): norm{1,2}_{scale,bias} (K, C),
qkv_kernel (K, C, 3C), qkv_bias (K, 3C) (V2: [q_bias, 0, v_bias]),
logit_scale (K, nH, 1, 1) (V2: exp(min(logit_scale, log 100)); V1 zeros),
proj_kernel (K, nH, D, C), proj_bias (K, C), fc1_kernel (K, C, Hd),
fc1_bias (K, Hd), fc2_kernel (K, Hd, C), fc2_bias (K, C), bias_table
(K, nH, N, N), mask (nW, N, N) (0 / -100; zeros for an unshifted chain).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from avmoe_tpu_torch.kernels import _build
from avmoe_tpu_torch.kernels.mlp_block import mlp_block
from avmoe_tpu_torch.ops.norm import layer_norm
from avmoe_tpu_torch.ops.swin import partition_windows, unpartition_windows

MAX_N = 144
MAX_D = 64
EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
OPERANDS = ("norm1_scale", "norm1_bias", "qkv_kernel", "qkv_bias", "logit_scale",
            "proj_kernel", "proj_bias", "norm2_scale", "norm2_bias", "fc1_kernel",
            "fc1_bias", "fc2_kernel", "fc2_bias", "bias_table", "mask")
_FLOAT32_OPERANDS = ("logit_scale", "bias_table", "mask")


@dataclasses.dataclass(frozen=True)
class ChainGeom:
    """Static geometry of a chain of K same-stage Swin blocks."""

    version: str                  # 'v1' | 'v2'
    H: int                        # token grid height
    W: int                        # token grid width
    C: int                        # channels
    num_heads: int
    window: int                   # effective window (after the shrink to the grid)
    shifts: Tuple[int, ...]       # per-block shift (len K)
    mlp_hidden: int
    part: str = "full"            # 'full' | 'attn' | 'mlp'

    @property
    def K(self) -> int:
        return len(self.shifts)

    @property
    def N(self) -> int:
        return self.window * self.window

    @property
    def nW(self) -> int:
        return (self.H // self.window) * (self.W // self.window)


@torch.no_grad()
def stack_chain(blocks, part: str = "full", dtype: torch.dtype = torch.float32):
    """Operands of a chain of same-(window, shift) SwinBlocks, and its geometry."""
    b0 = blocks[0]
    window, _ = b0._geometry()
    H, W = b0.input_resolution
    geom = ChainGeom(version=b0.version, H=H, W=W, C=b0.dim, num_heads=b0.num_heads,
                     window=window, shifts=tuple(b._geometry()[1] for b in blocks),
                     mlp_hidden=b0.mlp.fc1.out_features, part=part)
    nH, C = geom.num_heads, geom.C
    cols: Dict[str, List[torch.Tensor]] = {k: [] for k in OPERANDS[:-1]}
    for b in blocks:
        at = b.attn
        if b.version == "v2":
            qkv_kernel = at.qkv_kernel
            qkv_bias = torch.cat([at.q_bias, torch.zeros_like(at.q_bias), at.v_bias])
            logit_scale = torch.exp(torch.clamp(at.logit_scale[:, 0, 0], max=math.log(100.0)))
        else:
            qkv_kernel = at.qkv.weight.t()
            qkv_bias = (at.qkv.bias if at.qkv.bias is not None
                        else at.qkv.weight.new_zeros(3 * C))
            logit_scale = qkv_kernel.new_zeros(nH)
        m = b.mlp
        for key, val in (("norm1_scale", b.norm1.weight), ("norm1_bias", b.norm1.bias),
                         ("qkv_kernel", qkv_kernel), ("qkv_bias", qkv_bias),
                         ("logit_scale", logit_scale.reshape(nH, 1, 1)),
                         ("proj_kernel", at.proj.weight.t().reshape(nH, C // nH, C)),
                         ("proj_bias", at.proj.bias),
                         ("norm2_scale", b.norm2.weight), ("norm2_bias", b.norm2.bias),
                         ("fc1_kernel", m.fc1.weight.t()), ("fc1_bias", m.fc1.bias),
                         ("fc2_kernel", m.fc2.weight.t()), ("fc2_bias", m.fc2.bias),
                         ("bias_table", at.position_bias())):
            cols[key].append(val)
    ops = {k: torch.stack(v).to(torch.float32 if k in _FLOAT32_OPERANDS else dtype)
           for k, v in cols.items()}
    mask = b0.attn_mask
    if mask is None:
        mask = ops["bias_table"].new_zeros(geom.nW, geom.N, geom.N)
    ops["mask"] = mask.to(torch.float32)
    return ops, geom


def chain_groups(items: Sequence, key: Callable = lambda b: b._geometry()) -> List[list]:
    """Split a block list into maximal runs of one key, (window, shift) by default."""
    groups: List[list] = []
    for it in items:
        if groups and key(groups[-1][0]) == key(it):
            groups[-1].append(it)
        else:
            groups.append([it])
    return groups


# ---------------------------------------------------------------------------
# Plain version: the Pallas body over windowed tokens (G, N, C)
# ---------------------------------------------------------------------------


def _matmul(x2d: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """(R, Cin) @ (Cin, Cout) of compute-dtype values, float32 sums and result."""
    out = torch.matmul(x2d.float(), w.float())
    return out if bias is None else out + bias.float()


def _row_normalize(t: torch.Tensor) -> torch.Tensor:
    ss = (t * t).sum(dim=-1, keepdim=True)
    return t * torch.rsqrt(torch.clamp(ss, min=1e-24))


def _attn_sub(g: ChainGeom, k: int, x: torch.Tensor, ops) -> torch.Tensor:
    """Attention sub-block output (before the residual add) of block k."""
    G, N, C = x.shape
    nH = g.num_heads
    D = C // nH
    dt = x.dtype
    h = layer_norm(x, ops["norm1_scale"][k], ops["norm1_bias"][k], EPS) if g.version == "v1" else x
    qkv = _matmul(h.reshape(G * N, C), ops["qkv_kernel"][k], ops["qkv_bias"][k])
    qkv = qkv.reshape(G, N, 3, nH, D).permute(2, 0, 3, 1, 4)      # (3, G, nH, N, D) f32
    q, kk, v = qkv[0], qkv[1], qkv[2].to(dt)
    if g.version == "v2":
        q = _row_normalize(q) * ops["logit_scale"][k]
        kk = _row_normalize(kk)
    else:
        q = q * (D ** -0.5)
    logits = torch.matmul(q.to(dt).float(), kk.to(dt).float().transpose(-1, -2))
    logits = logits + ops["bias_table"][k]
    if g.shifts[k]:
        logits = (logits.reshape(G // g.nW, g.nW, nH, N, N)
                  + ops["mask"][:, None]).reshape(G, nH, N, N)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    pv = torch.matmul(p.float(), v.float()).to(dt)                # (G, nH, N, D)
    pv = pv.permute(0, 2, 1, 3).reshape(G * N, C)
    a = _matmul(pv, ops["proj_kernel"][k].reshape(C, C), ops["proj_bias"][k])
    a = a.to(dt).reshape(G, N, C)
    if g.version == "v2":
        a = layer_norm(a, ops["norm1_scale"][k], ops["norm1_bias"][k], EPS)
    return a


def _mlp_sub(g: ChainGeom, k: int, x: torch.Tensor, ops) -> torch.Tensor:
    """MLP sub-block output (before the residual add) of block k."""
    shape, dt = x.shape, x.dtype
    x = x.reshape(-1, shape[-1])
    h = layer_norm(x, ops["norm2_scale"][k], ops["norm2_bias"][k], EPS) if g.version == "v1" else x
    h = _matmul(h, ops["fc1_kernel"][k], ops["fc1_bias"][k]).to(dt)
    h = F.gelu(h.float(), approximate="none").to(dt)
    h = _matmul(h, ops["fc2_kernel"][k], ops["fc2_bias"][k]).to(dt)
    if g.version == "v2":
        h = layer_norm(h, ops["norm2_scale"][k], ops["norm2_bias"][k], EPS)
    return h.reshape(shape)


def block_chain_plain(xw: torch.Tensor, ops, geom: ChainGeom) -> torch.Tensor:
    """Plain PyTorch version of the kernel on windowed tokens (G, N, C)."""
    x = xw
    for k in range(geom.K):
        if geom.part in ("full", "attn"):
            x = x + _attn_sub(geom, k, x, ops)
        if geom.part in ("full", "mlp"):
            x = x + _mlp_sub(geom, k, x, ops)
    return x


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _operand_shapes(geom: ChainGeom) -> Dict[str, Tuple[int, ...]]:
    K, C, nH, N, Hd = geom.K, geom.C, geom.num_heads, geom.N, geom.mlp_hidden
    return {"norm1_scale": (K, C), "norm1_bias": (K, C), "qkv_kernel": (K, C, 3 * C),
            "qkv_bias": (K, 3 * C), "logit_scale": (K, nH, 1, 1),
            "proj_kernel": (K, nH, C // nH, C), "proj_bias": (K, C),
            "norm2_scale": (K, C), "norm2_bias": (K, C), "fc1_kernel": (K, C, Hd),
            "fc1_bias": (K, Hd), "fc2_kernel": (K, Hd, C), "fc2_bias": (K, C),
            "bias_table": (K, nH, N, N), "mask": (geom.nW, N, N)}


def _check(x: torch.Tensor, ops, geom: ChainGeom) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}; expected float32 or bfloat16")
    if geom.part not in ("full", "attn", "mlp"):
        raise ValueError(f"part must be 'full', 'attn' or 'mlp', got {geom.part!r}")
    if geom.version not in ("v1", "v2"):
        raise ValueError(f"version must be 'v1' or 'v2', got {geom.version!r}")
    if geom.K < 1 or len(set(geom.shifts)) != 1:
        raise ValueError(f"a chain needs K >= 1 blocks of one shift, got {geom.shifts}")
    if geom.H % geom.window or geom.W % geom.window or geom.C % geom.num_heads:
        raise ValueError(f"inconsistent geometry {geom}")
    D = geom.C // geom.num_heads
    if not (geom.N <= MAX_N and D <= MAX_D and geom.N % 4 == 0 and D % 4 == 0
            and geom.C % 8 == 0 and geom.mlp_hidden % 8 == 0):
        raise ValueError(f"kernel takes N <= {MAX_N}, D <= {MAX_D}, both multiples of 4, "
                         f"and C, Hd multiples of 8, got N={geom.N}, C={geom.C}, "
                         f"heads={geom.num_heads}, Hd={geom.mlp_hidden}")
    for name, shape in _operand_shapes(geom).items():
        t = ops[name]
        dtype = torch.float32 if name in _FLOAT32_OPERANDS else x.dtype
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _library() -> ctypes.CDLL:
    lib = _build.load("block_chain")
    fn = lib.block_chain_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


class BlockChain:
    """Callable wrapper of the kernel; `launches` counts kernel launches (one
    per chain call of part 'full' or 'attn')."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, ops, geom: ChainGeom) -> torch.Tensor:
        """Run the chain over flat tokens x (B, H*W, C)."""
        if x.dim() != 3 or tuple(x.shape[1:]) != (geom.H * geom.W, geom.C):
            raise ValueError(f"x must be (B, {geom.H * geom.W}, {geom.C}), got {tuple(x.shape)}")
        if geom.part == "mlp":
            _check(x, ops, geom)
            for k in range(geom.K):
                x = mlp_block(x, ops["norm2_scale"][k].float(), ops["norm2_bias"][k].float(),
                              ops["fc1_kernel"][k].t().contiguous(), ops["fc1_bias"][k].float(),
                              ops["fc2_kernel"][k].t().contiguous(), ops["fc2_bias"][k].float(),
                              pre_norm=geom.version == "v1", eps=EPS)
            return x
        shift = geom.shifts[0]
        xw = partition_windows(x, geom.H, geom.W, geom.window, shift)
        yw = self.windows(xw, ops, geom)
        return unpartition_windows(yw, geom.H, geom.W, geom.window, shift)

    def windows(self, xw: torch.Tensor, ops, geom: ChainGeom,
                cluster_windows: int = 0) -> torch.Tensor:
        """Run the chain (part 'full' or 'attn') over windowed tokens (G, N, C).

        cluster_windows: windows per thread-block cluster; 0 lets the kernel
        pick (the tests force it, to reach a ragged last cluster, and
        tools/k3_phase_ablation.py, to time one window per cluster)."""
        if cluster_windows < 0:
            raise ValueError(f"cluster_windows must be >= 0, got {cluster_windows}")
        if geom.part == "mlp":
            raise ValueError("part 'mlp' runs on flat tokens through K2; call block_chain()")
        if xw.dim() != 3 or tuple(xw.shape[1:]) != (geom.N, geom.C) or xw.shape[0] % geom.nW:
            raise ValueError(f"xw must be (G, {geom.N}, {geom.C}) with G a multiple of "
                             f"{geom.nW}, got {tuple(xw.shape)}")
        _check(xw, ops, geom)
        if xw.device.type == "cpu":
            return block_chain_plain(xw, ops, geom)
        if xw.device.type != "cuda":
            raise ValueError(f"block_chain: unsupported device {xw.device}")
        lib = _library()
        G, N, C = xw.shape
        full = geom.part == "full"
        new = lambda *shape, dtype=xw.dtype: torch.empty(shape, dtype=dtype, device=xw.device)
        out = torch.empty_like(xw)
        # scratch: the product inputs h, o, hid in the compute dtype; qkv,
        # the proj / fc2 output a and the residual stream xs in float32
        h, o = new(G, N, C), new(G, N, C)
        hid = new(G, N, geom.mlp_hidden) if full else None
        qkv = new(G, N, 3 * C, dtype=torch.float32)
        a, xs = new(G, N, C, dtype=torch.float32), new(G, N, C, dtype=torch.float32)
        tensors = [xw, out] + [ops[k] for k in OPERANDS] + [h, qkv, o, a, hid, xs]
        ptrs = (ctypes.c_void_p * len(tensors))(*(0 if t is None else t.data_ptr()
                                                  for t in tensors))
        dims = [G, N, C, geom.num_heads, geom.mlp_hidden, geom.K, geom.nW,
                int(geom.version == "v2"), int(full), int(geom.shifts[0] > 0),
                _DTYPE_CODE[xw.dtype], int(cluster_windows)]
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = lib.block_chain_fwd(ptrs, (ctypes.c_int * len(dims))(*dims), EPS, stream)
        if err != 0:
            raise RuntimeError(f"block_chain kernel failed: CUDA error {err}")
        self.launches += 1
        return out


block_chain = BlockChain()


def run_chain(blocks, x: torch.Tensor, part: str = "full") -> torch.Tensor:
    """Run SwinBlocks over flat tokens (B, L, C), one chain call per maximal
    run of one (window, shift)."""
    for grp in chain_groups(blocks):
        ops, geom = stack_chain(grp, part=part, dtype=x.dtype)
        x = block_chain(x, ops, geom)
    return x
