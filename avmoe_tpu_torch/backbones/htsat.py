"""HTS-AT audio encoder.

Counterpart of `avmoe_tpu/backbones/htsat.py`: waveform -> log-mel ->
per-mel-bin BatchNorm (`bn0`) -> [train: SpecAugment, mixup] -> wav2img
frequency fold -> patch embed ->
4 stages of Swin-V1 blocks with PatchMergingV1 downsamples, driven block
by block by the lock-step engine (`moe/injection.py`), or all at once
without adapters by `forward_features` (AVQA's grounding stage). The
encoder's `norm`, `tscam_conv` and `head` (standalone audio tagging) are on
neither path and are not built; `load_jax_variables` skips those leaves.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from avmoe_tpu_torch.audio import frontend as fe
from avmoe_tpu_torch.backbones.geometry import BlockSpec, stage_boundaries, swin_stage_specs
from avmoe_tpu_torch.config import HTSATConfig
from avmoe_tpu_torch.ops.norm import BatchNorm
from avmoe_tpu_torch.ops.swin import PatchEmbed, PatchMergingV1, SwinBlock
from avmoe_tpu_torch.utils.runtime import dropout_det


class HTSATEncoder(nn.Module):
    # flax subtrees of the JAX HTSATEncoder that the AVE forward never reads
    flax_off_path = ("norm", "tscam_conv", "head")

    def __init__(self, cfg: HTSATConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.bn0 = BatchNorm(cfg.frontend.n_mels)
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.embed_dim,
                                      (cfg.patch_size, cfg.patch_size), cfg.patch_stride,
                                      use_norm=cfg.patch_norm)
        self.blocks: List[SwinBlock] = []
        for s in self.block_specs:
            blk = SwinBlock(s.dim, s.resolution, s.num_heads, s.window_size, s.shift_size,
                            version="v1", mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                            drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
                            drop_path=s.drop_path)
            self.add_module(f"block_{s.stage}_{s.index_in_stage}", blk)
            self.blocks.append(blk)
        self.downsamples: List[PatchMergingV1] = []
        for i in range(len(cfg.depths) - 1):
            res = (cfg.patches_resolution[0] // 2**i, cfg.patches_resolution[1] // 2**i)
            ds = PatchMergingV1(cfg.embed_dim * 2**i, res)
            self.add_module(f"downsample_{i}", ds)
            self.downsamples.append(ds)

    @property
    def block_specs(self) -> List[BlockSpec]:
        c = self.cfg
        return swin_stage_specs(c.embed_dim, c.depths, c.num_heads, c.patches_resolution,
                                c.window_size, c.drop_path_rate)

    @property
    def stage_ranges(self) -> List[Tuple[int, int]]:
        return stage_boundaries(self.cfg.depths)

    def spectrogram_image(self, wave: torch.Tensor, *, train: bool = False,
                          mixup_lambda: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L) wave -> (B, S, S, 1) folded, bn0-normalized log-mel image.
        In train bn0 takes batch statistics (and updates its running ones,
        though its scale and bias are frozen), SpecAugment runs unless
        dropout_det, and mixup runs when λ is given."""
        c = self.cfg
        spec = fe.log_mel_spectrogram(wave.float(), c.frontend)
        spec = self.bn0(spec, train=train)
        if train and not dropout_det(train):
            if generator is None:
                raise ValueError("SpecAugment in train mode needs a torch.Generator")
            spec = fe.spec_augment(generator, spec, c.frontend)
        if train and mixup_lambda is not None:
            spec = fe.mixup(spec, mixup_lambda)
        return fe.reshape_wav2img(spec, c.spec_size, c.freq_ratio).to(self.dtype)

    def embed(self, wave: torch.Tensor, *, train: bool = False,
              mixup_lambda: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """wave -> (B, N0, embed_dim) patch tokens (lock-step entry point)."""
        return self.patch_embed(self.spectrogram_image(
            wave, train=train, mixup_lambda=mixup_lambda, generator=generator))

    def forward_features(self, x: torch.Tensor, *, train: bool = False,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Embedded tokens (B, N0, embed_dim) -> (B, N_last, num_features):
        every stage's blocks (K1 + K2 each), then its downsample; no adapters
        and no final norm. In train DropPath draws from `generator`."""
        for stage, (lo, hi) in enumerate(self.stage_ranges):
            for blk in self.blocks[lo:hi]:
                x = blk(x, train, generator)
            if stage < len(self.downsamples):
                x = self.downsamples[stage](x)
        return x
