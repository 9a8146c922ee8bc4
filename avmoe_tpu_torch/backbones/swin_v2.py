"""Swin-V2 vision encoder (timm swinv2_{base,large}_window12_192 geometry).

Counterpart of `avmoe_tpu/backbones/swin_v2.py`: patch embed, 4 stages of
post-norm V2 blocks with PatchMergingV2 downsamples, final norm. The
lock-step engine (`moe/injection.py`) drives the blocks one by one;
`forward_features` is the plain pass without adapters (AVQA's frozen pass
over its negative frames, and its grounding stage's passes), block by block
(K1 + K2 each) or, with `chains=True`, each stage's blocks as K3 chains.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from avmoe_tpu_torch.backbones.geometry import BlockSpec, stage_boundaries, swin_stage_specs
from avmoe_tpu_torch.config import SwinV2Config
from avmoe_tpu_torch.kernels.block_chain import run_chain
from avmoe_tpu_torch.ops.norm import LayerNorm
from avmoe_tpu_torch.ops.swin import PatchEmbed, PatchMergingV2, SwinBlock


class SwinV2Encoder(nn.Module):
    def __init__(self, cfg: SwinV2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.embed_dim,
                                      (cfg.patch_size, cfg.patch_size),
                                      (cfg.patch_size, cfg.patch_size), use_norm=True)
        self.blocks: List[SwinBlock] = []
        for s in self.block_specs:
            blk = SwinBlock(s.dim, s.resolution, s.num_heads, s.window_size, s.shift_size,
                            version="v2", mlp_ratio=cfg.mlp_ratio,
                            pretrained_window=s.pretrained_window, drop_path=s.drop_path)
            self.add_module(f"block_{s.stage}_{s.index_in_stage}", blk)
            self.blocks.append(blk)
        self.downsamples: List[PatchMergingV2] = []
        for i in range(len(cfg.depths) - 1):
            res = (cfg.patches_resolution[0] // 2**i, cfg.patches_resolution[1] // 2**i)
            ds = PatchMergingV2(cfg.embed_dim * 2**i, res)
            self.add_module(f"downsample_{i}", ds)
            self.downsamples.append(ds)
        self.norm = LayerNorm(cfg.num_features)

    @property
    def block_specs(self) -> List[BlockSpec]:
        c = self.cfg
        return swin_stage_specs(c.embed_dim, c.depths, c.num_heads, c.patches_resolution,
                                c.window_size, c.drop_path_rate, c.pretrained_window_sizes)

    @property
    def stage_ranges(self) -> List[Tuple[int, int]]:
        return stage_boundaries(self.cfg.depths)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, N0, embed_dim) tokens (lock-step entry point)."""
        return self.patch_embed(images.to(self.dtype))

    def forward_features(self, x: torch.Tensor, *, chains: bool = False, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The pass without adapters: embedded tokens (B, N0, embed_dim) ->
        (B, N_last, num_features) after the final norm, every stage's blocks,
        then its downsample. `chains` runs each stage as K3 chains (one per
        run of one (window, shift), `run_chain`; eval only). In train
        DropPath draws from `generator`."""
        if chains and train:
            raise ValueError("the chain path is eval only")
        for stage, (lo, hi) in enumerate(self.stage_ranges):
            if chains:
                x = run_chain(self.blocks[lo:hi], x, "full")
            else:
                for blk in self.blocks[lo:hi]:
                    x = blk(x, train, generator)
            if stage < len(self.downsamples):
                x = self.downsamples[stage](x)
        return self.norm(x)
