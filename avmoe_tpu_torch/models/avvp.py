"""AVVP: weakly-supervised audio-visual video parsing, the MGN model.

Counterpart of `avmoe_tpu/models/avvp.py`. The lock-step encoder with MoE
adapters in every stage, then class-aware grouping heads:

  f_a -> fc_a --------------------------------------+
  f_v -> fc_v ┐                                     |
  video_st -> fc_st ┴-> concat -> fc_fusion -> visual grouping (25 class tokens)
  audio grouping (HAN against the fused visual tokens) -> cross-modal grouping

Grouping runs per clip over the T segments. Inputs are batch-first and
channels-last, as in the JAX package:

  wave     (B, T, L)        raw waveform segments
  images   (B, T, H, W, 3)  normalized RGB frames
  video_st (B, T, st_dim)   r2plus1d clip features

and the output dict holds aud_cls_logits / vis_cls_logits (25, 25),
global_prob / a_prob / v_prob (B, 25), a_frame_prob / v_frame_prob
(B, T, 25) and telemetry (per-site gating probs, the summed lb_loss).

The encoder runs in the model's compute dtype; the pooled features enter the
heads as float32. `forward(..., train=False)` is the eval forward under
torch.no_grad; `forward(..., train=True, mixup_lambda=..., generator=...)`
the train forward (default path only), which draws DropPath, dropout,
SpecAugment and HAN's Gumbel noise from `generator`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.audio.frontend import get_mix_lambda
from avmoe_tpu_torch.config import AVVPConfig
from avmoe_tpu_torch.heads.grouping import ModalityTrans
from avmoe_tpu_torch.losses.avvp import avvp_loss
from avmoe_tpu_torch.metrics.avvp import AVVPEvaluator
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.moe.injection import LockstepEncoder


class MGNModel(nn.Module):
    def __init__(self, cfg: AVVPConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: Optional[int] = 0, block_chains: bool = False,
                 fused_moe: bool = False, fused_moe_train: bool = False):
        """Build on `device` (default the card; raises if it is absent) and,
        unless seed is None, initialize the parameters from `seed`.
        `block_chains` runs the backbones' blocks through K3 chains (eval only,
        `moe/injection.py`). `fused_moe` / `fused_moe_train`
        take the adapters' fused combine in eval / train (`moe/adapter.py`)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c, d = cfg, cfg.dim
        with torch.device(dev):
            self.encoder = LockstepEncoder(c.swin, c.htsat, c.moe, c.injection, dtype=dtype,
                                           block_chains=block_chains,
                                           fused_moe=fused_moe, fused_moe_train=fused_moe_train)
            self.fc_a = nn.Linear(c.htsat.num_features, d)
            self.fc_v = nn.Linear(c.swin.num_features, d)
            self.fc_st = nn.Linear(c.st_dim, d)
            self.fc_fusion = nn.Linear(2 * d, d)
            self.audio_token = nn.Parameter(torch.zeros(c.num_classes, d))
            self.visual_token = nn.Parameter(torch.zeros(c.num_classes, d))
            hard = c.unimodal_assign == "hard"
            groups = dict(num_group_tokens=c.num_classes, num_output_groups=c.num_classes)
            self.audio_cug = ModalityTrans(d, c.depth_aud, hard_assignment=hard, use_han=True,
                                           num_other_tokens=c.num_segments, **groups)
            self.visual_cug = ModalityTrans(d, c.depth_vis, hard_assignment=hard, **groups)
            self.av_mcg = ModalityTrans(d, c.depth_av,
                                        hard_assignment=c.crossmodal_assign == "hard", **groups)
            self.fc_prob = nn.Linear(d, 1)
            self.fc_prob_a = nn.Linear(d, 1)
            self.fc_prob_v = nn.Linear(d, 1)
            self.fc_cls = nn.Linear(d, c.num_classes)
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)

    def forward(self, wave: torch.Tensor, images: torch.Tensor, video_st: torch.Tensor, *,
                train: bool = False, mixup_lambda: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(wave, images, video_st, False, None, None)
        return self._forward(wave, images, video_st, True, mixup_lambda, generator)

    def _forward(self, wave, images, video_st, train: bool, mixup_lambda, generator) -> Dict:
        c = self.cfg
        B, T = wave.shape[0], wave.shape[1]
        f_v, f_a, telemetry = self.encoder(
            wave.reshape(B * T, -1), images.reshape((B * T,) + tuple(images.shape[2:])),
            train=train, mixup_lambda=mixup_lambda, generator=generator)
        f_v = f_v.float().reshape(B, T, -1)
        f_a = f_a.float().reshape(B, T, -1)

        x1_0 = self.fc_a(f_a)                                       # (B, T, d)
        x2_0 = self.fc_fusion(torch.cat([self.fc_v(f_v), self.fc_st(video_st.float())], dim=-1))
        x2, attn_vis, _ = self.visual_cug(x2_0, self.visual_token, train=train,
                                          return_attn=True, generator=generator)
        x1, attn_aud, _ = self.audio_cug(x1_0, self.audio_token, x_other=x2_0, train=train,
                                         return_attn=True, generator=generator)
        x, _, _ = self.av_mcg(x1, x2, train=train, return_attn=True, generator=generator)

        global_prob = torch.sigmoid(self.fc_prob(x))[..., 0]       # (B, 25)
        # soft assignment maps: (B, groups=25, segments=T)
        attn_a = attn_aud[c.unimodal_assign][:, :, :T]
        attn_v = attn_vis[c.unimodal_assign][:, :, :T]
        a_prob_tok = torch.sigmoid(self.fc_prob_a(x1))              # (B, 25, 1)
        v_prob_tok = torch.sigmoid(self.fc_prob_v(x2))
        return {
            "aud_cls_logits": self.fc_cls(self.audio_token),         # (25, 25)
            "vis_cls_logits": self.fc_cls(self.visual_token),
            "global_prob": global_prob,
            "a_prob": a_prob_tok[..., 0],
            "v_prob": v_prob_tok[..., 0],
            "a_frame_prob": (a_prob_tok * attn_a).transpose(1, 2),  # (B, T, 25)
            "v_frame_prob": (v_prob_tok * attn_v).transpose(1, 2),
            "telemetry": telemetry,
        }


def make_avvp_loss_fn(model: MGNModel, lb_weight: float = 1.0):
    """Loss closure of a train step: (model, batch, generator) -> (loss, aux),
    `avvp_loss` with the summed load-balance loss at lb_weight. Without a
    `mixup_lambda` in the batch, λ is drawn per frame from Beta(0.5, 0.5)."""
    del model  # the step passes the model it trains

    def loss_fn(model: MGNModel, batch: Dict, generator: Optional[torch.Generator]):
        lam = batch.get("mixup_lambda")
        if lam is None and generator is not None:
            B, T = batch["wave"].shape[0], batch["wave"].shape[1]
            lam = get_mix_lambda(generator, 0.5, B * T, device=batch["wave"].device)
        out = model(batch["wave"], batch["images"], batch["video_st"], train=True,
                    mixup_lambda=lam, generator=generator)
        return avvp_loss(out, batch["labels"], lb_weight=lb_weight)

    return loss_fn


def make_avvp_eval_fn(model: MGNModel, gt_audio: Mapping[int, np.ndarray],
                      gt_visual: Mapping[int, np.ndarray]) -> Callable:
    """Eval closure eval_fn(batch, evaluator) -> {"telemetry": ...}: the
    eval forward, then each clip's global_prob, a_frame_prob and v_frame_prob
    into the `AVVPEvaluator` against its (25, T) ground-truth grids, looked up
    by batch["clip_index"] (all zeros where a clip has none)."""

    def eval_fn(batch: Dict, evaluator: AVVPEvaluator) -> Dict:
        out = model(batch["wave"], batch["images"], batch["video_st"])
        gp, ap, vp = (out[k].float().cpu().numpy()
                      for k in ("global_prob", "a_frame_prob", "v_frame_prob"))
        blank = np.zeros((gp.shape[-1], ap.shape[1]), np.int64)
        for i, clip in enumerate(torch.as_tensor(batch["clip_index"]).tolist()):
            evaluator.add_clip(gp[i], ap[i], vp[i], gt_audio.get(int(clip), blank),
                               gt_visual.get(int(clip), blank))
        return {"telemetry": out["telemetry"]}

    return eval_fn
