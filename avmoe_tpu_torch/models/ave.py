"""AVE: audio-visual event localization model.

Counterpart of `avmoe_tpu/models/ave.py`. Inputs are batch-first and
channels-last, as in the JAX package:

  wave   (B, T, L)        raw waveform segments
  images (B, T, H, W, 3)  normalized RGB frames

and the output is a dict: is_event_logits (B, T), event_logits (B, cls),
av_score (B, cls), telemetry (per-site gating probs, lb_loss). The config
picks the head: temporal attention (or, with is_temporal_att=False, one
ReLU Linear per stream and dropout 0.1) into CMBS (with is_inter_in_cmbs,
its interaction blocks); or, with is_cmbs=False, the forward-only
classification path mlp_class -> mlp_class_2 -> softmax, whose output is
segment_probs (B, T, cls + 1) and telemetry.

The encoder runs in the model's compute dtype (float32 or bfloat16, master
weights float32); the pooled features enter the heads as float32, as the
JAX package's heads promote them.

`forward(..., train=False)` is the eval forward, under torch.no_grad.
`forward(..., train=True, mixup_lambda=..., generator=...)` is the train
forward: batch-statistics norms (updating the running stats in place),
dropout, DropPath and SpecAugment drawn from `generator` (a torch.Generator
on the model's device), mixup with the given per-frame λ. It runs on the
default path only; `make_ave_loss_fn` builds the loss of a train step
(`train/steps.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.audio.frontend import get_mix_lambda
from avmoe_tpu_torch.config import AVEConfig
from avmoe_tpu_torch.heads.ave import CMBSHead, TemporalAttention
from avmoe_tpu_torch.heads.common import DenseGeneral, LSTMCell
from avmoe_tpu_torch.losses.ave import ave_loss
from avmoe_tpu_torch.metrics.ave import ave_accuracy
from avmoe_tpu_torch.moe.adapter import GroupedDense, MoEAdapter
from avmoe_tpu_torch.moe.injection import LockstepEncoder
from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm
from avmoe_tpu_torch.ops.swin import WindowAttentionV1, WindowAttentionV2


class AVEModel(nn.Module):
    def __init__(self, cfg: AVEConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: Optional[int] = 0, block_chains: bool = False,
                 fused_moe: bool = False, fused_moe_train: bool = False):
        """Build on `device` (default the card; raises if it is absent) and,
        unless seed is None, initialize the parameters from `seed`.
        `block_chains` runs the backbones' blocks through K3 chains
        (`moe/injection.py`). `fused_moe` / `fused_moe_train`
        take the adapters' fused combine in eval / train (`moe/adapter.py`)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c_v, c_a = cfg.swin.num_features, cfg.htsat.num_features
        with torch.device(dev):
            self.encoder = LockstepEncoder(cfg.swin, cfg.htsat, cfg.moe, cfg.injection,
                                           dtype=dtype, block_chains=block_chains,
                                           fused_moe=fused_moe, fused_moe_train=fused_moe_train)
            if not cfg.is_cmbs:
                self.mlp_class = nn.Linear(c_v + c_a, 512)
                self.mlp_class_2 = nn.Linear(512, cfg.num_classes + 1)
            elif cfg.is_temporal_att:
                self.temporal_attn = TemporalAttention(
                    video_input_dim=c_v, audio_input_dim=c_a, d_model=cfg.d_model)
            else:
                self.v_fc = nn.Linear(c_v, cfg.d_model)
                self.a_fc = nn.Linear(c_a, cfg.d_model)
            if cfg.is_cmbs:
                self.cmbs = CMBSHead(num_classes=cfg.num_classes, d_model=cfg.d_model,
                                     inter=cfg.is_inter_in_cmbs)
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)

    def forward(self, wave: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(wave, images, False, None, None)
        return self._forward(wave, images, True, mixup_lambda, generator)

    def _forward(self, wave, images, train: bool, mixup_lambda, generator) -> Dict:
        B, T = wave.shape[0], wave.shape[1]
        f_v, f_a, telemetry = self.encoder(
            wave.reshape(B * T, -1), images.reshape((B * T,) + tuple(images.shape[2:])),
            train=train, mixup_lambda=mixup_lambda, generator=generator)
        f_v, f_a = f_v.float().reshape(B, T, -1), f_a.float().reshape(B, T, -1)
        if not self.cfg.is_cmbs:
            logits = self.mlp_class_2(self.mlp_class(torch.cat([f_v, f_a], dim=-1)))
            return {"segment_probs": torch.softmax(logits, dim=-1), "telemetry": telemetry}
        if self.cfg.is_temporal_att:
            visual, audio, _ = self.temporal_attn(f_v, f_a, train, generator)
        else:
            visual = dropout(F.relu(self.v_fc(f_v)), 0.1, train=train, generator=generator)
            audio = dropout(F.relu(self.a_fc(f_a)), 0.1, train=train, generator=generator)
        is_event_logits, event_logits, av_score = self.cmbs(visual, audio, train, generator)
        return {"is_event_logits": is_event_logits, "event_logits": event_logits,
                "av_score": av_score, "telemetry": telemetry}


def make_ave_loss_fn(model: AVEModel, lb_weight: float = 0.0, mixup_alpha: float = 0.5):
    """Loss closure of a train step: (model, batch, generator) -> (loss, aux),
    loss = BCE + 2 CE (+ lb_weight LB), accuracy in aux. Without a
    `mixup_lambda` in the batch, λ is drawn per frame from Beta(α, α) with
    α = mixup_alpha (0 turns mixup off)."""
    del model  # the step passes the model it trains

    def loss_fn(model: AVEModel, batch: Dict, generator: Optional[torch.Generator]):
        lam = batch.get("mixup_lambda")
        if lam is None and mixup_alpha > 0 and generator is not None:
            B, T = batch["wave"].shape[0], batch["wave"].shape[1]
            lam = get_mix_lambda(generator, mixup_alpha, B * T, device=batch["wave"].device)
        out = model(batch["wave"], batch["images"], train=True, mixup_lambda=lam,
                    generator=generator)
        loss, aux = ave_loss(out, batch["labels"], lb_weight)
        with torch.no_grad():
            aux["accuracy"] = ave_accuracy(out["is_event_logits"], out["event_logits"],
                                           batch["labels"])
        return loss, aux

    return loss_fn


def make_ave_eval_fn(model: AVEModel) -> Callable[[Dict], Dict]:
    """Eval closure: accuracy + telemetry for the expert-usage tracker."""

    def eval_fn(batch: Dict) -> Dict:
        out = model(batch["wave"], batch["images"])
        return {"accuracy": ave_accuracy(out["is_event_logits"], out["event_logits"],
                                         batch["labels"]),
                "telemetry": out["telemetry"]}

    return eval_fn


def _lecun_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax lecun_normal: truncated normal (2 std) with variance 1/fan_in."""
    std = 1.0 / math.sqrt(max(fan_in, 1)) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """Random initialization after the JAX package's flax initializers
    (lecun-normal kernels, zero biases, unit norms, zero adapter gates,
    uniform latent tokens, log(10) logit scales, normal embeddings)."""
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (LayerNorm, BatchNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif isinstance(mod, nn.Linear) or isinstance(mod, LSTMCell):
                if name.startswith("weight"):
                    _lecun_(p, p.shape[1], gen)
                else:
                    p.zero_()
            elif isinstance(mod, nn.Embedding):
                # flax nn.Embed: normal with variance 1/features
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            elif isinstance(mod, nn.Conv2d):
                if name == "weight":
                    _lecun_(p, p[0].numel(), gen)
                else:
                    p.zero_()
            elif isinstance(mod, GroupedDense):
                _lecun_(p, p.shape[-2], gen)
            elif isinstance(mod, DenseGeneral):
                if name == "kernel":
                    # query/key/value (C, H, D) have an (H, D) bias; out (H, D, C) a
                    # (C,) one; the adapters' stacked MHA has a leading expert axis
                    in_q = mod.bias.dim() == p.dim() - 1
                    _lecun_(p, p.shape[-3] if in_q else p.shape[-3] * p.shape[-2], gen)
                else:
                    p.zero_()
            elif isinstance(mod, WindowAttentionV1) and name == "relative_position_bias_table":
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=gen)
            elif isinstance(mod, WindowAttentionV2) and name == "qkv_kernel":
                _lecun_(p, p.shape[0], gen)
            elif isinstance(mod, WindowAttentionV2) and name == "logit_scale":
                p.fill_(math.log(10.0))
            elif name == "token_proj_kernel":   # (N, M): the MoE and DG-SCT adapters'
                _lecun_(p, p.shape[1], gen)
            elif isinstance(mod, MoEAdapter) and name == "fc_kernel":
                _lecun_(p, p.shape[0], gen)
            elif name == "latent_tokens":
                p.uniform_(0.0, 1.0, generator=gen)
            else:  # biases, gates, gate_av
                p.zero_()
        for name, b in mod.named_buffers(recurse=False):
            if isinstance(mod, BatchNorm):
                b.fill_(0.0 if name == "running_mean" else 1.0)
