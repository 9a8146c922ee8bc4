"""The original AVSBench segmentation model, without MoE adapters: a PVT-v2-b5
or ResNet-50 encoder, ASPP projections per stage, TPAVI audio-visual
attention, the FPN decoder, driven by VGGish audio embeddings (B, T, 128).

Counterpart of `avmoe_tpu/models/avs_baseline.py:27` `AVSBaselineModel`,
same module names and output keys: frames (B, T, H, W, 3) channels-last ->
mask_logits (B*T, H, W), feature_map_list (the four maps after TPAVI, as the
JAX model returns them, not relu'd) and a_fea_list (TPAVI's aligned audio
(B, T, channel) per TPAVI stage, None elsewhere), so that `losses/avs.py`
`iou_semantic_aware_loss` applies. The model runs in float32, as the JAX
one does (it has no dtype knob). The VGGish embeddings come from
`backbones/vggish.py` (`waveform_to_examples`, then `VGGish`), a frozen
extractor outside the model, as in the reference.

`forward(..., train=False)` is the eval forward under torch.no_grad;
`forward(..., train=True, generator=...)` the train forward: BatchNorm on
batch statistics (updating the running ones), PVT's DropPath from the
generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.backbones.pvt import pvt_v2_b5
from avmoe_tpu_torch.backbones.resnet import B2ResNet
from avmoe_tpu_torch.heads.avs import (
    ASPPClassifier, Conv2d, FeatureFusionBlock, TPAVIModule, resize_bilinear)
from avmoe_tpu_torch.losses.avs import iou_semantic_aware_loss
from avmoe_tpu_torch.models.ave import init_parameters

Gen = Optional[torch.Generator]


class AVSBaselineModel(nn.Module):
    def __init__(self, backbone: str = "pvt", channel: int = 256, num_segments: int = 5,
                 tpavi_stages: Sequence[int] = (0, 1, 2, 3), tpavi_vv_flag: bool = False,
                 tpavi_va_flag: bool = True, device="cuda", seed: Optional[int] = 0,
                 encoder: Optional[nn.Module] = None):
        """`backbone` 'pvt' (PVT-v2-b5) or 'resnet' (B2ResNet, ResNet-50);
        `encoder` replaces the backbone's default build (a cut-down one, the
        tests' counterpart of patching the JAX module's constructor); its
        `widths` are the pyramid's channels. Built
        on `device` (default the card; raises if it is absent) and, unless
        seed is None, initialized from `seed` after flax's initializers
        (TPAVI's W_z conv kernel and BN scale at zero)."""
        super().__init__()
        if backbone not in ("pvt", "resnet"):
            raise ValueError(f"backbone {backbone!r}: 'pvt' or 'resnet'")
        dev = resolve_device(device)
        self.backbone, self.channel, self.num_segments = backbone, channel, num_segments
        self.tpavi_vv_flag, self.tpavi_va_flag = tpavi_vv_flag, tpavi_va_flag
        with torch.device(dev):
            if encoder is None:
                encoder = pvt_v2_b5() if backbone == "pvt" else B2ResNet()
            self.encoder_backbone = encoder
            self.convs = []
            for i in range(4):
                m = ASPPClassifier(encoder.widths[i], channel)
                self.add_module(f"conv{i + 1}", m)
                self.convs.append(m)
            self.paths = []
            for i in range(4):
                m = FeatureFusionBlock(channel, skip=i < 3)
                self.add_module(f"path_{i}", m)
                self.paths.append(m)
            self.tpavi = {}
            for i in tpavi_stages:
                m = TPAVIModule(channel)
                self.add_module(f"tpavi_b{i + 1}", m)
                self.tpavi[i] = m
            self.out_conv1 = Conv2d(channel, 128, 3, padding=1)
            self.out_conv2 = Conv2d(128, 32, 3, padding=1)
            self.out_conv3 = Conv2d(32, 1, 1)
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)
            with torch.no_grad():
                for m in self.tpavi.values():
                    m.W_z_bn.weight.zero_()

    def forward(self, images: torch.Tensor, audio_feature: torch.Tensor, *,
                train: bool = False, generator: Gen = None) -> Dict:
        """images (B, T, H, W, 3), audio_feature (B, T, 128)."""
        if not train:
            with torch.no_grad():
                return self._forward(images, audio_feature, False, None)
        return self._forward(images, audio_feature, True, generator)

    def _forward(self, images, audio_feature, train: bool, generator: Gen) -> Dict:
        B, T = images.shape[0], images.shape[1]
        x = images.reshape((B * T,) + tuple(images.shape[2:]))
        if self.backbone == "pvt":
            pyramid = self.encoder_backbone(x, train, generator)
        else:
            pyramid = self.encoder_backbone(x, train)
        maps = [conv(p) for conv, p in zip(self.convs, pyramid)]

        a_fea_list: List[Optional[torch.Tensor]] = [None] * 4
        for i, tpavi in self.tpavi.items():
            h, w = maps[i].shape[1], maps[i].shape[2]
            x5 = maps[i].reshape(B, T, h, w, self.channel)
            feats, count = torch.zeros_like(x5), 0
            if self.tpavi_vv_flag:
                z, _ = tpavi(x5, None, train)
                feats, count = feats + z, count + 1
            if self.tpavi_va_flag:
                z, a_fea_list[i] = tpavi(x5, audio_feature, train)
                feats, count = feats + z, count + 1
            maps[i] = (feats / count).reshape(B * T, h, w, self.channel)

        y = self.paths[3](maps[3])
        for i in (2, 1, 0):
            y = self.paths[i](y, maps[i])
        y = self.out_conv1(y)
        y = resize_bilinear(y, 2 * y.shape[1], 2 * y.shape[2], align_corners=False)
        logits = self.out_conv3(F.relu(self.out_conv2(y)))[..., 0]
        return {"mask_logits": logits, "feature_map_list": maps, "a_fea_list": a_fea_list}


def make_avs_baseline_loss_fn(model: AVSBaselineModel):
    """Loss closure of a train step (`train/steps.py` `make_train_step`):
    (model, batch, generator) -> (loss, aux), the S4 IoU-BCE loss of
    batch["mask"] ((B, H, W) first frames) on the forward of
    batch["images"] and batch["audio_feature"]."""

    def loss_fn(model: AVSBaselineModel, batch: Dict, generator: Gen):
        out = model(batch["images"], batch["audio_feature"], train=True, generator=generator)
        return iou_semantic_aware_loss(out["mask_logits"], batch["mask"], out["a_fea_list"],
                                       out["feature_map_list"], setting="s4",
                                       num_frames=model.num_segments)

    return loss_fn

