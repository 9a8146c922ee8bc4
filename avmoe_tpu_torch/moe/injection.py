"""Lock-step dual-backbone encoder with MoE adapter injection.

Counterpart of `avmoe_tpu/moe/injection.py`, with the semantics of its
unfused branch: the Swin-V2 and HTS-AT backbones run block by block in
lock-step. Stages whose (index+1) % num_skip == 0 run without adapters.
Where the visual stage is deeper, audio block k rides visual block
r*k + (r-1). At each site the p1 adapters read the pre-block features of
both modalities; the visual block splits at its attention/MLP seam while
the audio block runs whole between the p1 and p2 adapters.

`plan_stages` is the static walk both paths take: per stage, runs of whole
adapter-free blocks and the adapter sites between them. With
`block_chains=True` (the JAX package's fused-blocks configuration,
experiments/pallas/fused_block.py) every run goes through K3 chains
(`kernels/block_chain.py`, one chain per maximal same-(window, shift) run),
each site's visual attention sub-block is a K=1 'attn' chain and its audio
block a K=1 'full' chain; the visual MLP sub-block stays on K2.
`chain_calls` and `kernel_launches` give the K3 calls and the launches per
forward from the configs alone (`swin_chain_calls` and `swin_pass_launches`
those of a plain Swin-V2 pass, AVQA's frozen negative pass);
`backward_launches` the K1b / K2b launches of a train step's backward on
the default path. The chain path is eval
only, as the JAX package's Pallas chain is inference-only: its train forward
raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from avmoe_tpu_torch.backbones.geometry import BlockSpec, stage_boundaries, swin_stage_specs
from avmoe_tpu_torch.backbones.htsat import HTSATEncoder
from avmoe_tpu_torch.backbones.swin_v2 import SwinV2Encoder
from avmoe_tpu_torch.config import HTSATConfig, InjectionConfig, MoEConfig, SwinV2Config
from avmoe_tpu_torch.kernels.block_chain import ChainGeom, chain_groups, run_chain
from avmoe_tpu_torch.moe.adapter import MoEAdapter


@dataclass(frozen=True)
class AdapterSite:
    """One injection site: a (visual block, audio block) pair in a non-skipped stage."""

    site_index: int
    stage: int
    vis_block: int
    aud_block: int
    vis_dim: int
    aud_dim: int
    vis_tokens: int
    aud_tokens: int


def pair_stage_blocks(n_vis: int, n_aud: int) -> List[Tuple[int, Optional[int]]]:
    """[(vis_offset, aud_offset-or-None)] pairing within one stage."""
    if n_vis == n_aud:
        return [(i, i) for i in range(n_vis)]
    if n_vis % n_aud:
        raise ValueError(f"visual depth {n_vis} is not a multiple of audio depth {n_aud}")
    r = n_vis // n_aud
    return [(i, i // r if i % r == r - 1 else None) for i in range(n_vis)]


def plan_injection(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig,
                   inj: InjectionConfig) -> List[AdapterSite]:
    """Static injection plan: the sites of `plan_stages`, with their widths."""
    specs = _specs(swin_cfg, htsat_cfg)
    sites: List[AdapterSite] = []
    for stage, steps in enumerate(plan_stages(swin_cfg, htsat_cfg, inj)):
        for st in steps:
            if st.kind != "site":
                continue
            vs, as_ = specs["swin"][st.vis[0]], specs["htsat"][st.aud[0]]
            sites.append(AdapterSite(
                site_index=st.site, stage=stage, vis_block=st.vis[0], aud_block=st.aud[0],
                vis_dim=vs.dim, aud_dim=as_.dim, vis_tokens=vs.num_tokens,
                aud_tokens=as_.num_tokens))
    return sites


@dataclass(frozen=True)
class Step:
    """One step of a stage: whole adapter-free blocks of each backbone
    (kind 'run'), or one adapter site (kind 'site', one block of each)."""

    kind: str
    vis: Tuple[int, ...]          # flat Swin-V2 block indices
    aud: Tuple[int, ...]          # flat HTS-AT block indices
    site: int = -1


def plan_stages(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig,
                inj: InjectionConfig) -> List[List[Step]]:
    """Per stage, the runs of adapter-free blocks and the sites, in order."""
    v_ranges = stage_boundaries(swin_cfg.depths)
    a_ranges = stage_boundaries(htsat_cfg.depths)
    stages: List[List[Step]] = []
    site = 0
    for stage in range(len(swin_cfg.depths)):
        skipped = inj.num_skip > 1 and (stage + 1) % inj.num_skip == 0
        (vlo, vhi), (alo, ahi) = v_ranges[stage], a_ranges[stage]
        steps: List[Step] = []
        vis: List[int] = []
        aud: List[int] = []
        for v_off, a_off in pair_stage_blocks(vhi - vlo, ahi - alo):
            if a_off is None or skipped:
                vis.append(vlo + v_off)
                if a_off is not None:
                    aud.append(alo + a_off)
                continue
            if vis or aud:
                steps.append(Step("run", tuple(vis), tuple(aud)))
                vis, aud = [], []
            steps.append(Step("site", (vlo + v_off,), (alo + a_off,), site))
            site += 1
        if vis or aud:
            steps.append(Step("run", tuple(vis), tuple(aud)))
        stages.append(steps)
    return stages


def _specs(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig) -> Dict[str, List[BlockSpec]]:
    return {"swin": swin_stage_specs(swin_cfg.embed_dim, swin_cfg.depths, swin_cfg.num_heads,
                                     swin_cfg.patches_resolution, swin_cfg.window_size),
            "htsat": swin_stage_specs(htsat_cfg.embed_dim, htsat_cfg.depths,
                                      htsat_cfg.num_heads, htsat_cfg.patches_resolution,
                                      htsat_cfg.window_size)}


@dataclass(frozen=True)
class ChainCall:
    """One K3 launch of the chain path: a backbone's blocks and their geometry."""

    backbone: str                 # 'swin' | 'htsat'
    stage: int
    blocks: Tuple[int, ...]
    geom: ChainGeom


def _chain_group_calls(spec: List[BlockSpec], backbone: str, stage: int, idx: Tuple[int, ...],
                       part: str, version: str, ratio: float) -> List[ChainCall]:
    """The K3 calls of one run of blocks: one per maximal same-(window, shift) group."""
    calls = []
    for grp in chain_groups(list(idx), key=lambda i: spec[i].window_shift):
        s0 = spec[grp[0]]
        geom = ChainGeom(version=version, H=s0.resolution[0], W=s0.resolution[1],
                         C=s0.dim, num_heads=s0.num_heads, window=s0.window_shift[0],
                         shifts=tuple(spec[i].window_shift[1] for i in grp),
                         mlp_hidden=int(s0.dim * ratio), part=part)
        calls.append(ChainCall(backbone, stage, tuple(grp), geom))
    return calls


def chain_calls(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig,
                inj: InjectionConfig) -> List[ChainCall]:
    """The K3 calls of one chain-path forward, in order, from the configs alone."""
    specs = _specs(swin_cfg, htsat_cfg)
    meta = {"swin": ("v2", swin_cfg.mlp_ratio), "htsat": ("v1", htsat_cfg.mlp_ratio)}
    calls: List[ChainCall] = []

    def add(backbone: str, stage: int, idx: Tuple[int, ...], part: str) -> None:
        calls.extend(_chain_group_calls(specs[backbone], backbone, stage, idx, part,
                                        *meta[backbone]))

    for stage, steps in enumerate(plan_stages(swin_cfg, htsat_cfg, inj)):
        for st in steps:
            if st.kind == "run":
                add("swin", stage, st.vis, "full")
                add("htsat", stage, st.aud, "full")
            else:
                add("swin", stage, st.vis, "attn")
                add("htsat", stage, st.aud, "full")
    return calls


def swin_chain_calls(swin_cfg: SwinV2Config) -> List[ChainCall]:
    """The K3 calls of a plain Swin-V2 pass on the chain path
    (`SwinV2Encoder.forward_features(chains=True)`): each stage's blocks,
    part 'full'."""
    spec = swin_stage_specs(swin_cfg.embed_dim, swin_cfg.depths, swin_cfg.num_heads,
                            swin_cfg.patches_resolution, swin_cfg.window_size)
    return [c for stage, (lo, hi) in enumerate(stage_boundaries(swin_cfg.depths))
            for c in _chain_group_calls(spec, "swin", stage, tuple(range(lo, hi)), "full",
                                        "v2", swin_cfg.mlp_ratio)]


def swin_pass_launches(swin_cfg: SwinV2Config, block_chains: bool) -> Dict[str, int]:
    """Launches of K1, K2 and K3 of one plain Swin-V2 pass (no adapters)."""
    if block_chains:
        return {"K1": 0, "K2": 0, "K3": len(swin_chain_calls(swin_cfg))}
    blocks = sum(swin_cfg.depths)
    return {"K1": blocks, "K2": blocks, "K3": 0}


def backward_launches(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig, inj: InjectionConfig,
                      frozen_scopes: Tuple[str, ...] = ("swin", "htsat")) -> Dict[str, int]:
    """Launches of K1b (window-attention backward) and K2b (MLP-block
    backward) per train step on the default path, with the backbones in
    `frozen_scopes` ("swin", "htsat") frozen. A frozen backbone's sub-block
    launches its backward only where its input needs a gradient: after the
    first adapter residual of its backbone has been added (an adapter's
    output depends on trainable parameters), so the sub-blocks that run
    before it launch none. A trainable backbone's sub-blocks all launch it
    (their weights need gradients), from the first block on."""
    grad = {"v": "swin" not in frozen_scopes, "a": "htsat" not in frozen_scopes}
    k1b = k2b = 0

    def blocks(side: str, n: int, whole: bool = True) -> None:
        nonlocal k1b, k2b
        if grad[side]:
            k1b += n
            k2b += n if whole else 0

    for steps in plan_stages(swin_cfg, htsat_cfg, inj):
        for st in steps:
            if st.kind == "run":
                blocks("v", len(st.vis))
                blocks("a", len(st.aud))
                continue
            blocks("v", 1, whole=False)          # visual attention sub-block
            if inj.audio_adapter_p1:
                grad["v"] = True
            blocks("a", 1)                       # the whole audio block
            if inj.audio_adapter_p1:
                grad["a"] = True
            k2b += int(grad["v"])                # visual MLP sub-block
            if inj.audio_adapter_p2:             # p2 residuals land after it
                grad["v"] = grad["a"] = True
    return {"K1b": k1b, "K2b": k2b}


def kernel_launches(swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig, inj: InjectionConfig,
                    block_chains: bool) -> Dict[str, int]:
    """Launches of K1 (window attention), K2 (MLP block) and K3 (block chain)
    per forward."""
    blocks = sum(swin_cfg.depths) + sum(htsat_cfg.depths)
    if not block_chains:
        return {"K1": blocks, "K2": blocks, "K3": 0}
    sites = len(plan_injection(swin_cfg, htsat_cfg, inj))
    return {"K1": 0, "K2": sites, "K3": len(chain_calls(swin_cfg, htsat_cfg, inj))}


class LockstepEncoder(nn.Module):
    """Dual-backbone lock-step encoder with per-site MoE adapters.

    forward(wave (B', L), images (B', H, W, 3), *, train, mixup_lambda,
    generator) -> (f_v (B', C_v), f_a (B', C_a), telemetry); B' = clips *
    segments. `block_chains` runs the blocks through K3 chains (see the
    module docstring; eval only). `fused_moe` / `fused_moe_train` put every
    `MoEAdapter` on the fused combine in eval / train (`moe/adapter.py`).
    """

    def __init__(self, swin_cfg: SwinV2Config, htsat_cfg: HTSATConfig, moe_cfg: MoEConfig,
                 injection_cfg: InjectionConfig, dtype: torch.dtype = torch.float32,
                 block_chains: bool = False, fused_moe: bool = False,
                 fused_moe_train: bool = False):
        super().__init__()
        self.swin_cfg, self.htsat_cfg = swin_cfg, htsat_cfg
        self.moe_cfg, self.injection_cfg = moe_cfg, injection_cfg
        self.block_chains = block_chains
        self.swin = SwinV2Encoder(swin_cfg, dtype=dtype)
        self.htsat = HTSATEncoder(htsat_cfg, dtype=dtype)
        self.sites = plan_injection(swin_cfg, htsat_cfg, injection_cfg)
        self.plan = plan_stages(swin_cfg, htsat_cfg, injection_cfg)
        self.adapters: Dict[str, List[MoEAdapter]] = {}
        inj = injection_cfg
        kinds = []
        if inj.audio_adapter_p1:
            kinds += [("audio_moe_p1", True), ("vis_moe_p1", False)]
        if inj.audio_adapter_p2:
            kinds += [("audio_moe_p2", True), ("vis_moe_p2", False)]
        for prefix, audio_side in kinds:
            cfg = moe_cfg
            # vis-side adapters keep their own gate flag
            if not audio_side and cfg.adapter.vis_use_gate != cfg.adapter.use_gate:
                cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(
                    cfg.adapter, use_gate=cfg.adapter.vis_use_gate))
            mods = []
            for s in self.sites:
                m = MoEAdapter(
                    dim=s.aud_dim if audio_side else s.vis_dim,
                    other_dim=s.vis_dim if audio_side else s.aud_dim,
                    num_tokens=s.aud_tokens if audio_side else s.vis_tokens,
                    other_num_tokens=s.vis_tokens if audio_side else s.aud_tokens,
                    cfg=cfg, fused_moe=fused_moe, fused_moe_train=fused_moe_train)
                self.add_module(f"{prefix}_{s.site_index}", m)
                mods.append(m)
            self.adapters[prefix] = mods

    def forward(self, wave: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Pooled features: visual after the final norm, audio without norm."""
        f_v, f_a, telemetry = self.forward_tokens(
            wave, images, train=train, mixup_lambda=mixup_lambda, generator=generator)
        return f_v.mean(dim=1), f_a.mean(dim=1), telemetry

    def forward_tokens(self, wave: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                       mixup_lambda: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       collect_stages: bool = False):
        """f_v (B', N_last, C_v) after the final visual norm, f_a (B', M_last,
        C_a) un-normed, and telemetry: per-kind (sites, B', E) gating probs
        and the summed lb_loss. With collect_stages, telemetry['stage_tokens']
        holds each stage's visual tokens before its downsample, the last
        stage's normed (AVS's multi-scale capture)."""
        if train and self.block_chains:
            raise NotImplementedError(
                "the chain path (block_chains=True) is eval only, as the JAX package's fused "
                "block chain is inference-only; train on the default path")
        inj = self.injection_cfg
        swin, htsat = self.swin, self.htsat
        f_v = swin.embed(images)
        f_a = htsat.embed(wave, train=train, mixup_lambda=mixup_lambda, generator=generator)
        tele: Dict[str, List[torch.Tensor]] = {
            "audio_p1": [], "audio_p2": [], "video_p1": [], "video_p2": []}
        lb_losses: List[torch.Tensor] = []
        stage_tokens: List[torch.Tensor] = []

        def run(prefix: str, site: int, x, other):
            out, aux = self.adapters[prefix][site](x, other, train, generator)
            if "lb_loss" in aux:
                lb_losses.append(aux["lb_loss"])
            return out, aux["gating_probs"]

        def blocks(mods, idx, x, part="full"):
            mods = [mods[i] for i in idx]
            if self.block_chains and mods:
                return run_chain(mods, x, part)
            for b in mods:
                x = b.attn_state(x, train, generator) if part == "attn" else b(x, train, generator)
            return x

        for stage, steps in enumerate(self.plan):
            for st in steps:
                if st.kind == "run":
                    f_v = blocks(swin.blocks, st.vis, f_v)
                    f_a = blocks(htsat.blocks, st.aud, f_a)
                    continue
                site = st.site
                # p1: adapters on the pre-block features
                if inj.audio_adapter_p1:
                    f_a_res, p = run("audio_moe_p1", site, f_a, f_v)
                    tele["audio_p1"].append(p)
                    f_v_res, p = run("vis_moe_p1", site, f_v, f_a)
                    tele["video_p1"].append(p)
                f_v = blocks(swin.blocks, st.vis, f_v, "attn")
                if inj.audio_adapter_p1:
                    f_v = f_v + f_v_res
                f_a = blocks(htsat.blocks, st.aud, f_a)  # whole audio block between the seams
                if inj.audio_adapter_p1:
                    f_a = f_a + f_a_res
                # p2: adapters around the visual MLP sub-block
                if inj.audio_adapter_p2:
                    f_a_res2, p = run("audio_moe_p2", site, f_a, f_v)
                    tele["audio_p2"].append(p)
                    f_v_res2, p = run("vis_moe_p2", site, f_v, f_a)
                    tele["video_p2"].append(p)
                f_v = swin.blocks[st.vis[0]].mlp_state(f_v, train, generator)
                if inj.audio_adapter_p2:
                    f_v = f_v + f_v_res2
                    f_a = f_a + f_a_res2
            if collect_stages:
                last = stage == len(self.plan) - 1
                stage_tokens.append(swin.norm(f_v) if last else f_v)
            if stage < len(swin.downsamples):
                f_v = swin.downsamples[stage](f_v)
            if stage < len(htsat.downsamples):
                f_a = htsat.downsamples[stage](f_a)

        f_v = swin.norm(f_v)
        telemetry = {k: torch.stack(v, dim=0) if v else torch.zeros(0, device=f_v.device)
                     for k, v in tele.items()}
        telemetry["lb_loss"] = (torch.stack(lb_losses).sum() if lb_losses
                                else torch.zeros((), device=f_v.device))
        if collect_stages:
            telemetry["stage_tokens"] = stage_tokens
        return f_v, f_a, telemetry
