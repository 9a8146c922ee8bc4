"""AVS: audio-visual sound-source segmentation (S4 and MS3).

Counterpart of `avmoe_tpu/models/avs.py`:

  frames (B, T, 224, 224, 3) -> bicubic to Swin's 192 -> the lock-step
  encoder with MoE adapters in every stage, each stage's visual tokens
  taken before its downsample -> per stage Dense to `channel` and bicubic
  to the pyramid (56, 28, 14, 7) -> four-scale temporal attention -> TPAVI
  on the audio per stage -> FPN fusion -> mask logits (B*T, 224, 224)

Inputs are batch-first and channels-last, as in the JAX package: waves (B,
T, L), frames (B, T, H, W, 3). The output dict holds mask_logits (B*T, mask,
mask), feature_map_list (the four pyramid maps after TPAVI, relu'd, as the
reference's in-place ReLUs leave them), a_fea_list (TPAVI's aligned audio
(B, T, channel) per TPAVI stage, None elsewhere) and telemetry.

The encoder runs in the model's compute dtype; its tokens enter the decoder
as float32, as the JAX package's float32 decoder parameters promote them.
`forward(..., train=False)` is the eval forward under torch.no_grad;
`forward(..., train=True, mixup_lambda=..., generator=...)` the train
forward (default path only).

The 'mha' expert attends across the batch's frames, so a frame's output
depends on the other clips of its batch, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.audio.frontend import get_mix_lambda
from avmoe_tpu_torch.config import AVSConfig
from avmoe_tpu_torch.heads.avs import (
    Conv2d, FeatureFusionBlock, MultiScaleTemporalAttention, TPAVIModule, resize_bicubic,
    resize_bilinear)
from avmoe_tpu_torch.losses.avs import iou_semantic_aware_loss
from avmoe_tpu_torch.metrics.avs import eval_fmeasure, mask_iou
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.moe.injection import LockstepEncoder, backward_launches, kernel_launches

Gen = Optional[torch.Generator]


class AVSModel(nn.Module):
    def __init__(self, cfg: AVSConfig, dtype: torch.dtype = torch.float32, device="cuda",
                 seed: Optional[int] = 0, block_chains: bool = False,
                 fused_moe: bool = False, fused_moe_train: bool = False):
        """Build on `device` (default the card; raises if it is absent) and,
        unless seed is None, initialize the parameters from `seed`.
        `block_chains` runs the backbones' blocks through K3 chains (eval
        only, `moe/injection.py`). `fused_moe` / `fused_moe_train`
        take the adapters' fused combine in eval / train (`moe/adapter.py`)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        with torch.device(dev):
            self.encoder = LockstepEncoder(c.swin, c.htsat, c.moe, c.injection, dtype=dtype,
                                           block_chains=block_chains,
                                           fused_moe=fused_moe, fused_moe_train=fused_moe_train)
            self.stage_proj = []
            for i in range(len(c.swin.depths)):
                m = nn.Linear(c.swin.embed_dim * 2 ** i, c.channel)
                self.add_module(f"stage_proj_{i}", m)
                self.stage_proj.append(m)
            self.audio_linear = nn.Linear(c.htsat.num_features, 128)
            self.temporal_attn = MultiScaleTemporalAttention(
                d_model=c.channel, num_segments=c.num_segments, gamma=c.temporal_gamma)
            self.tpavi = {}
            for i in c.tpavi_stages:
                m = TPAVIModule(c.channel)
                self.add_module(f"tpavi_b{i + 1}", m)
                self.tpavi[i] = m
            self.paths = []
            for i in range(4):
                m = FeatureFusionBlock(c.channel, skip=i < 3)
                self.add_module(f"path_{i}", m)
                self.paths.append(m)
            self.out_conv1 = Conv2d(c.channel, 128, 3, padding=1)
            self.out_conv2 = Conv2d(128, 32, 3, padding=1)
            self.out_conv3 = Conv2d(32, 1, 1)
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)
            with torch.no_grad():        # flax's zero inits of TPAVI's W_z
                for m in self.tpavi.values():
                    m.W_z_bn.weight.zero_()

    def forward(self, images: torch.Tensor, wave: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None, generator: Gen = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(images, wave, False, None, None)
        return self._forward(images, wave, True, mixup_lambda, generator)

    def _forward(self, images, wave, train: bool, mixup_lambda, generator) -> Dict:
        c = self.cfg
        B, T = images.shape[0], images.shape[1]
        imgs = images.reshape((B * T,) + tuple(images.shape[2:]))
        S = c.swin.img_size
        imgs = resize_bicubic(imgs, S, S)
        _, f_a, telemetry = self.encoder.forward_tokens(
            wave.reshape(B * T, -1), imgs, train=train, mixup_lambda=mixup_lambda,
            generator=generator, collect_stages=True)
        stage_tokens = telemetry.pop("stage_tokens")
        audio_feature = self.audio_linear(f_a.float().mean(dim=1).reshape(B, T, -1))

        maps = []
        res0 = c.swin.patches_resolution[0]
        for i, tokens in enumerate(stage_tokens):
            r, p = res0 // 2 ** i, c.pyramid_sizes[i]
            grid = self.stage_proj[i](tokens.float()).reshape(-1, r, r, c.channel)
            maps.append(resize_bicubic(grid, p, p))
        maps, audio_flat = self.temporal_attn(maps, audio_feature, train, generator)

        a_fea_list: List[Optional[torch.Tensor]] = [None] * 4
        audio_seq = audio_flat.reshape(B, T, -1)
        for i, tpavi in self.tpavi.items():
            h, w = maps[i].shape[1], maps[i].shape[2]
            x5 = maps[i].reshape(B, T, h, w, c.channel)
            feats, count = torch.zeros_like(x5), 0
            if c.tpavi_vv_flag:
                z, _ = tpavi(x5, None, train)
                feats, count = feats + z, count + 1
            if c.tpavi_va_flag:
                z, a_fea_list[i] = tpavi(x5, audio_seq, train)
                feats, count = feats + z, count + 1
            maps[i] = (feats / count).reshape(B * T, h, w, c.channel)

        x = self.paths[3](maps[3])
        for i in (2, 1, 0):
            x = self.paths[i](x, maps[i])
        x = self.out_conv1(x)
        x = resize_bilinear(x, 2 * x.shape[1], 2 * x.shape[2], align_corners=False)
        logits = self.out_conv3(F.relu(self.out_conv2(x)))[..., 0]
        return {"mask_logits": logits, "feature_map_list": [F.relu(m) for m in maps],
                "a_fea_list": a_fea_list, "telemetry": telemetry}


def avs_kernel_launches(cfg: AVSConfig, block_chains: bool) -> Dict[str, int]:
    """Launches of K1, K2 and K3 per forward: the lock-step encoder's (the
    decoder runs no kernel)."""
    return kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains)


def avs_frozen_scopes(cfg: AVSConfig):
    """The backbones a train step freezes: S4's recipe trains HTS-AT, MS3's
    freezes both."""
    return ("swin",) if cfg.setting == "s4" else ("swin", "htsat")


def avs_backward_launches(cfg: AVSConfig) -> Dict[str, int]:
    """Launches of K1b and K2b per train step of the setting's recipe (S4:
    every HTS-AT sub-block, its weights training)."""
    return backward_launches(cfg.swin, cfg.htsat, cfg.injection, avs_frozen_scopes(cfg))


def make_avs_loss_fn(model: AVSModel):
    """Loss closure of a train step: (model, batch, generator) -> (loss, aux):
    the setting's IoU-BCE (+ lambda_1 times the masked audio-visual loss)
    + lb_loss_weight times the routers' summed load-balance loss. Without a
    `mixup_lambda` in the batch, λ is drawn per frame from Beta(0.5, 0.5)."""
    cfg = model.cfg

    def loss_fn(model: AVSModel, batch: Dict, generator: Gen):
        lam = batch.get("mixup_lambda")
        if lam is None and generator is not None:
            B, T = batch["wave"].shape[0], batch["wave"].shape[1]
            lam = get_mix_lambda(generator, 0.5, B * T, device=batch["wave"].device)
        out = model(batch["images"], batch["wave"], train=True, mixup_lambda=lam,
                    generator=generator)
        loss, aux = iou_semantic_aware_loss(
            out["mask_logits"], batch["mask"], out["a_fea_list"], out["feature_map_list"],
            setting=cfg.setting, num_frames=cfg.num_segments, lambda_1=cfg.lambda_1,
            count_stages=cfg.sa_loss_stages, sa_loss_flag=cfg.sa_loss_flag,
            kind=cfg.sa_loss_kind, closer=cfg.closer_loss, norm_fea=cfg.sa_norm_fea,
            threshold=cfg.sa_threshold)
        lb = out["telemetry"]["lb_loss"]
        aux["loss_lb"] = lb
        return loss + cfg.lb_loss_weight * lb, aux

    return loss_fn


def make_avs_eval_fn(model: AVSModel) -> Callable[[Dict], Dict]:
    """Eval closure: the mask IoU and F-measure of batch["mask"] (B*T, H, W)
    or (B, T, H, W), and the telemetry."""

    def eval_fn(batch: Dict) -> Dict:
        out = model(batch["images"], batch["wave"])
        logits = out["mask_logits"].float()
        gt = batch["mask"].reshape(logits.shape)
        return {"miou": mask_iou(logits, gt), "fmeasure": eval_fmeasure(logits, gt),
                "telemetry": out["telemetry"]}

    return eval_fn
