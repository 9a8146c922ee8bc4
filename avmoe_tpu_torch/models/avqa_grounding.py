"""AVQA stage A: the grounding pretraining model.

Counterpart of `avmoe_tpu/models/avqa_grounding.py`. The frozen Swin-V2 and
HTS-AT run their whole passes without adapters (`forward_features`: K1 + K2
a block; HTS-AT without its final norm), then the heads the fusion model
takes over in stage B (`cli/train_avqa.py --grounding_ckpt`):

  wave -> htsat.forward_features -> token mean -> fc_a1 ReLU fc_a2 -> a
  posi / nega frames -> swin.forward_features -> grid
  match(a, ground(a, grid)) -> (B, 2) logits for each of posi and nega

with `ground` and `match` those of `AVQAFusionModel`. Inputs are one
segment a sample: wave (B, L), posi and nega (B, H, W, 3).

The backbones run in the caller's mode with no gradient: in train, HTS-AT's
`bn0` normalizes with the batch's statistics and updates its running ones,
SpecAugment and DropPath draw from the generator; only the heads train.
The module names are the flax tree's (swin, htsat, fc_a1, fc_a2, fc_gl,
fc1 .. fc4), so `convert.load_jax_variables` fills the model from the JAX
model's variables.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.backbones.htsat import HTSATEncoder
from avmoe_tpu_torch.backbones.swin_v2 import SwinV2Encoder
from avmoe_tpu_torch.config import AVQAConfig
from avmoe_tpu_torch.losses.classification import cross_entropy_with_logits
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.models.avqa import AVQAFusionModel
from avmoe_tpu_torch.moe.injection import swin_pass_launches

Gen = Optional[torch.Generator]


class AVQAGroundingModel(nn.Module):
    def __init__(self, cfg: AVQAConfig, dtype: torch.dtype = torch.float32, device="cuda",
                 seed: Optional[int] = 0):
        """Build on `device` (default the card; raises if it is absent) and,
        unless seed is None, initialize the parameters from `seed`."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        d = c.d_feat
        with torch.device(dev):
            self.swin = SwinV2Encoder(c.swin, dtype=dtype)
            self.htsat = HTSATEncoder(c.htsat, dtype=dtype)
            self.fc_a1 = nn.Linear(c.htsat.num_features, d)
            self.fc_a2 = nn.Linear(d, d)
            self.fc_gl = nn.Linear(2 * d, d)
            self.fc1 = nn.Linear(2 * d, 512)
            self.fc2 = nn.Linear(512, 256)
            self.fc3 = nn.Linear(256, 128)
            self.fc4 = nn.Linear(128, 2)
        self.match_mlp = [self.fc1, self.fc2, self.fc3, self.fc4]
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)

    # the fusion model's grounding and matching heads, on the same names
    ground = AVQAFusionModel.ground
    match = AVQAFusionModel.match

    def features(self, wave: torch.Tensor, posi: torch.Tensor, nega: torch.Tensor,
                 train: bool = False, generator: Gen = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The frozen passes, without gradient, as float32: HTS-AT's token
        mean (B, C_a) and the positive and negative frames' grids (B, P, C)."""
        htsat, swin = self.htsat, self.swin
        with torch.no_grad():
            tokens = htsat.embed(wave, train=train, generator=generator)
            f_a = htsat.forward_features(tokens, train=train, generator=generator)
            grids = [swin.forward_features(swin.embed(x), train=train, generator=generator)
                     for x in (posi, nega)]
        return f_a.float().mean(dim=1), grids[0].float(), grids[1].float()

    def forward(self, wave: torch.Tensor, posi: torch.Tensor, nega: torch.Tensor, *,
                train: bool = False, generator: Gen = None) -> Dict[str, torch.Tensor]:
        f_a, grid_posi, grid_nega = self.features(wave, posi, nega, train, generator)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            audio_feat = self.fc_a2(torch.relu(self.fc_a1(f_a)))
            return {"match_posi": self.match(audio_feat, self.ground(audio_feat, grid_posi)),
                    "match_nega": self.match(audio_feat, self.ground(audio_feat, grid_nega))}


def grounding_kernel_launches(cfg: AVQAConfig) -> Dict[str, int]:
    """Launches of K1, K2 and K3 per forward: HTS-AT's blocks once, Swin-V2's
    twice (positive and negative frames); no backward kernel, since the
    backbones run without gradient."""
    swin = swin_pass_launches(cfg.swin, block_chains=False)
    audio = sum(cfg.htsat.depths)
    return {"K1": 2 * swin["K1"] + audio, "K2": 2 * swin["K2"] + audio, "K3": 0}


def grounding_loss(out: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy of the positive rows' match logits against label 1 and
    the negative rows' against 0, and the accuracy (percent)."""
    posi, nega = out["match_posi"], out["match_nega"]
    logits = torch.cat([posi, nega], dim=0)
    labels = torch.cat([torch.ones(posi.shape[0], dtype=torch.long, device=posi.device),
                        torch.zeros(nega.shape[0], dtype=torch.long, device=nega.device)])
    loss = cross_entropy_with_logits(logits, labels)
    with torch.no_grad():
        acc = (logits.argmax(dim=-1) == labels).float().mean() * 100.0
    return loss, {"accuracy": acc}


def make_grounding_loss_fn(model: AVQAGroundingModel):
    """Loss closure of a train step: (model, batch, generator) -> (loss, aux)
    over batch["wave"], batch["posi"], batch["nega"]."""
    del model  # the step passes the model it trains

    def loss_fn(model: AVQAGroundingModel, batch: Dict, generator: Gen):
        out = model(batch["wave"], batch["posi"], batch["nega"], train=True,
                    generator=generator)
        return grounding_loss(out)

    return loss_fn
