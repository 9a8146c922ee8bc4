"""Legacy AVE models: the pre-MoE generations beside the MoE AVE model.

Counterpart of `avmoe_tpu/models/ave_legacy.py`:

  * MMILNetV1: one DG-SCT adapter per site and side (`moe/dgsct_adapter.py`)
    in the Swin-V2 x HTS-AT lock-step, adapters in every stage; the final
    streams pooled by the last p2 adapters' spatial maps; TemporalAttention
    and CMBS heads. Same I/O as `AVEModel`, plus av_gate (B, T).
  * MMILNetV2, the LAVisH baseline: ONE frozen Swin-V2 runs both
    modalities (the audio as a Kaldi-fbank image repeated to 3 channels),
    four LAVisH adapters a block; mean-pool, concat, two Linear layers.
    Input audio_spec (B, T, S, S) and images (B, T, S, S, 3); output
    event_probs (the softmax) and event_logits, (B·T, C+1).

Every block runs K1 (window attention) and K2 (the MLP sub-block), and in a
train step K1b and K2b under them. Dtypes follow the JAX models at the
compute dtype `dtype`: the blocks compute in it, but an adapter returns
float32 (its gates and LayerNorms are float32 parameters), so a stream
becomes float32 at the first adapter residual of a stage and goes back to
the compute dtype at the next downsample. A block whose input stream is
float32 computes its sub-blocks in the compute dtype, as the JAX blocks
do, and adds their residuals to the float32 stream (`attn_state`,
`mlp_state` here); K2, whose residual add is inside the kernel, gets the
stream in the compute dtype and its increment is added back in float32.

`mmil_v1_*_launches` and `mmil_v2_*_launches` give each model's launches of
K1 / K2 per forward and K1b / K2b per train step from the config alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.audio.frontend import get_mix_lambda
from avmoe_tpu_torch.backbones.geometry import swin_stage_specs
from avmoe_tpu_torch.backbones.htsat import HTSATEncoder
from avmoe_tpu_torch.backbones.swin_v2 import SwinV2Encoder
from avmoe_tpu_torch.config import AdapterConfig, AVEConfig, InjectionConfig, SwinV2Config
from avmoe_tpu_torch.heads.ave import CMBSHead, TemporalAttention
from avmoe_tpu_torch.losses.ave import ave_labels, ave_loss
from avmoe_tpu_torch.losses.classification import binary_cross_entropy_with_logits
from avmoe_tpu_torch.metrics.ave import ave_accuracy
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.moe.adapter import _Bottleneck
from avmoe_tpu_torch.moe.dgsct_adapter import DGSCTAdapter
from avmoe_tpu_torch.moe.injection import (backward_launches, kernel_launches,
                                           pair_stage_blocks, plan_injection,
                                           swin_pass_launches)
from avmoe_tpu_torch.ops.norm import LayerNorm
from avmoe_tpu_torch.ops.swin import SwinBlock

# MMIL_Net v1 adapts every stage
V1_INJECTION = InjectionConfig(num_skip=1)
Gen = Optional[torch.Generator]


def attn_state(blk: SwinBlock, x: torch.Tensor, dt: torch.dtype, train: bool,
               generator: Gen) -> torch.Tensor:
    """x + the block's attention residual, computed in dt."""
    return x + blk.attn_residual(x.to(dt), train, generator)


def mlp_state(blk: SwinBlock, x: torch.Tensor, dt: torch.dtype, train: bool,
              generator: Gen) -> torch.Tensor:
    """x + the block's MLP residual: one K2 call in dt; a stream of another
    dtype gets K2's increment over its input in its own dtype."""
    if x.dtype == dt:
        return blk.mlp_state(x, train, generator)
    xc = x.to(dt)
    return x + (blk.mlp_state(xc, train, generator).to(x.dtype) - xc.to(x.dtype))


def block(blk: SwinBlock, x: torch.Tensor, dt: torch.dtype, train: bool,
          generator: Gen) -> torch.Tensor:
    return mlp_state(blk, attn_state(blk, x, dt, train, generator), dt, train, generator)


class LAVisHAdapter(nn.Module):
    """Latent-token cross attention into the other stream (same width: both
    streams run one backbone), then the bottleneck. forward(x (B, N, C),
    other (B, M, C), train) -> (B, N, C), float32 where a gate or ln_post
    is configured."""

    def __init__(self, dim: int, cfg: AdapterConfig, use_gate: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.use_gate = use_gate
        self.latent_tokens = nn.Parameter(torch.zeros(cfg.num_tokens, dim))
        self.gate_av = nn.Parameter(torch.zeros(1))
        if cfg.before_layernorm:
            self.ln_before = LayerNorm(dim)
        self.bottleneck = _Bottleneck(dim, cfg, use_activation=True, num=None)
        if cfg.post_layernorm:
            self.ln_post = LayerNorm(dim)
        if use_gate:
            self.gate = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        dt = self.dtype
        rep = self.latent_tokens.to(dt)[None].expand(x.shape[0], -1, -1)
        ot = other.to(dt)
        a1 = torch.softmax(torch.einsum("btc,bmc->btm", rep, ot), dim=-1)
        rep = rep + torch.einsum("btm,bmc->btc", a1, ot)
        a2 = torch.softmax(torch.einsum("bnc,btc->bnt", x.to(dt), rep), dim=-1)
        x = x + self.gate_av * torch.einsum("bnt,btc->bnc", a2, rep)   # float32
        if self.cfg.before_layernorm:
            x = self.ln_before(x)
        out = self.bottleneck(x.to(dt), train)
        if self.cfg.post_layernorm:
            out = self.ln_post(out.float())
        if self.use_gate:
            out = self.gate * out
        return out


class DGSCTLockstepEncoder(nn.Module):
    """Swin-V2 x HTS-AT lock-step with one DG-SCT adapter per site and side
    (`V1_INJECTION`: every stage). At a site the p1 adapters read both
    pre-block streams; the visual block splits at its attention / MLP seam,
    the audio block runs whole between the p1 and p2 adapters, with its p1
    residual added after it. The visual p1 / p2 adapters keep their gate
    whatever the config's use_gate says.

    forward(wave (B', L), images (B', H, W, 3), *, train, mixup_lambda,
    generator) -> (f_v (B', 1, C_v), f_a (B', 1, C_a)): the visual stream
    after the final norm and the audio stream un-normed, each pooled by the
    last p2 adapter's spatial map."""

    KINDS = ("audio_adapter_p1", "vis_adapter_p1", "audio_adapter_p2", "vis_adapter_p2")

    def __init__(self, swin_cfg: SwinV2Config, htsat_cfg, adapter_cfg: AdapterConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.swin_cfg, self.htsat_cfg = swin_cfg, htsat_cfg
        self.dtype = dtype
        self.swin = SwinV2Encoder(swin_cfg, dtype=dtype)
        self.htsat = HTSATEncoder(htsat_cfg, dtype=dtype)
        self.sites = plan_injection(swin_cfg, htsat_cfg, V1_INJECTION)
        vis_cfg = dataclasses.replace(adapter_cfg, use_gate=True)
        self.adapters: Dict[str, list] = {}
        for prefix in self.KINDS:
            audio = prefix.startswith("audio")
            mods = []
            for s in self.sites:
                m = DGSCTAdapter(
                    dim=s.aud_dim if audio else s.vis_dim,
                    other_dim=s.vis_dim if audio else s.aud_dim,
                    num_tokens=s.aud_tokens if audio else s.vis_tokens,
                    other_num_tokens=s.vis_tokens if audio else s.aud_tokens,
                    cfg=adapter_cfg if audio else vis_cfg, dtype=dtype)
                self.add_module(f"{prefix}_{s.site_index}", m)
                mods.append(m)
            self.adapters[prefix] = mods

    def forward(self, wave: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None, generator: Gen = None):
        dt = self.dtype
        swin, htsat, ad = self.swin, self.htsat, self.adapters
        f_v = swin.embed(images)
        f_a = htsat.embed(wave, train=train, mixup_lambda=mixup_lambda, generator=generator)
        site = 0
        v_maps = a_maps = None
        for stage, ((vlo, vhi), (alo, ahi)) in enumerate(zip(swin.stage_ranges,
                                                              htsat.stage_ranges)):
            for v_off, a_off in pair_stage_blocks(vhi - vlo, ahi - alo):
                blk_v = swin.blocks[vlo + v_off]
                if a_off is None:
                    f_v = block(blk_v, f_v, dt, train, generator)
                    continue
                blk_a = htsat.blocks[alo + a_off]
                f_a_res, _ = ad["audio_adapter_p1"][site](f_a, f_v, train)
                f_v_res, _ = ad["vis_adapter_p1"][site](f_v, f_a, train)
                f_v = attn_state(blk_v, f_v, dt, train, generator) + f_v_res
                f_a = block(blk_a, f_a, dt, train, generator) + f_a_res
                f_a_res, a_maps = ad["audio_adapter_p2"][site](f_a, f_v, train)
                f_v_res, v_maps = ad["vis_adapter_p2"][site](f_v, f_a, train)
                f_v = mlp_state(blk_v, f_v, dt, train, generator) + f_v_res
                f_a = f_a + f_a_res
                site += 1
            if stage < len(swin.downsamples):
                f_v = swin.downsamples[stage](f_v.to(dt))
            if stage < len(htsat.downsamples):
                f_a = htsat.downsamples[stage](f_a.to(dt))
        f_v = swin.norm(f_v).to(dt)
        f_v = torch.einsum("bon,bnc->boc", v_maps.to(f_v.dtype), f_v)
        f_a = torch.einsum("bon,bnc->boc", a_maps.to(f_a.dtype), f_a)
        return f_v, f_a


def _build(model: nn.Module, device, seed: Optional[int]) -> None:
    dev = resolve_device(device)
    model.to(dev)
    model.eval()
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_parameters(model, gen)


class MMILNetV1(nn.Module):
    """MMIL_Net v1: the DG-SCT encoder, TemporalAttention and CMBS. Built on
    `device` (default the card; raises if it is absent) and, unless seed is
    None, initialized from `seed`. forward(wave (B, T, L), images (B, T, H,
    W, 3), *, train, mixup_lambda, generator) -> is_event_logits (B, T),
    event_logits and av_score (B, cls), av_gate (B, T): the temporal
    attention's sigmoid gate values, which the v1 loss feeds to a
    BCE-with-logits as they are, and an empty telemetry."""

    def __init__(self, cfg: AVEConfig, dtype: torch.dtype = torch.float32, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = DGSCTLockstepEncoder(cfg.swin, cfg.htsat, cfg.moe.adapter,
                                                dtype=dtype)
            self.temporal_attn = TemporalAttention(
                video_input_dim=cfg.swin.num_features, audio_input_dim=cfg.htsat.num_features,
                d_model=cfg.d_model)
            self.cmbs = CMBSHead(num_classes=cfg.num_classes, d_model=cfg.d_model,
                                 inter=cfg.is_inter_in_cmbs)
        _build(self, device, seed)

    def forward(self, wave: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None, generator: Gen = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(wave, images, False, None, None)
        return self._forward(wave, images, True, mixup_lambda, generator)

    def _forward(self, wave, images, train, mixup_lambda, generator) -> Dict:
        B, T = wave.shape[0], wave.shape[1]
        f_v, f_a = self.encoder(wave.reshape(B * T, -1),
                                images.reshape((B * T,) + tuple(images.shape[2:])),
                                train=train, mixup_lambda=mixup_lambda, generator=generator)
        f_v, f_a = f_v.float().reshape(B, T, -1), f_a.float().reshape(B, T, -1)
        visual, audio, av_gate = self.temporal_attn(f_v, f_a, train, generator)
        is_event_logits, event_logits, av_score = self.cmbs(visual, audio, train, generator)
        return {"is_event_logits": is_event_logits, "event_logits": event_logits,
                "av_score": av_score, "av_gate": av_gate[..., 0], "telemetry": {}}


class MMILNetV2(nn.Module):
    """MMIL_Net_v2, the LAVisH baseline: one frozen Swin-V2 for both
    streams, LAVisH adapters p1 / p2 at every block (the visual ones keep
    their gate), mean-pool, concat, mlp_class -> mlp_class_2. Built as
    `MMILNetV1` is. forward(audio_spec (B, T, S, S), images (B, T, S, S,
    3), *, train, generator) -> event_probs (the softmax; the LAVisH loss
    applies its BCE-with-logits to it) and event_logits, (B·T, cls + 1),
    and an empty telemetry."""

    KINDS = DGSCTLockstepEncoder.KINDS

    def __init__(self, cfg: AVEConfig, dtype: torch.dtype = torch.float32, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.swin
        specs = swin_stage_specs(c.embed_dim, c.depths, c.num_heads, c.patches_resolution,
                                 c.window_size)
        a_cfg = cfg.moe.adapter
        with torch.device(resolve_device(device)):
            self.swin = SwinV2Encoder(c, dtype=dtype)
            self.adapters: Dict[str, list] = {}
            for prefix in self.KINDS:
                gate = a_cfg.use_gate if prefix.startswith("audio") else True
                mods = []
                for i, s in enumerate(specs):
                    m = LAVisHAdapter(s.dim, a_cfg, use_gate=gate, dtype=dtype)
                    self.add_module(f"{prefix}_{i}", m)
                    mods.append(m)
                self.adapters[prefix] = mods
            self.mlp_class = nn.Linear(2 * c.num_features, 512)
            self.mlp_class_2 = nn.Linear(512, cfg.num_classes + 1)
        _build(self, device, seed)

    def forward(self, audio_spec: torch.Tensor, images: torch.Tensor, *, train: bool = False,
                generator: Gen = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(audio_spec, images, False, None)
        return self._forward(audio_spec, images, True, generator)

    def _forward(self, audio_spec, images, train, generator) -> Dict:
        dt = self.dtype
        swin, ad = self.swin, self.adapters
        B, T = audio_spec.shape[0], audio_spec.shape[1]
        spec = audio_spec.reshape((B * T,) + tuple(audio_spec.shape[2:]))
        f_v = swin.embed(images.reshape((B * T,) + tuple(images.shape[2:])))
        f_a = swin.embed(spec[..., None].repeat(1, 1, 1, 3))
        for stage, (lo, hi) in enumerate(swin.stage_ranges):
            for b in range(lo, hi):
                blk = swin.blocks[b]
                f_a_res = ad["audio_adapter_p1"][b](f_a, f_v, train)
                f_v_res = ad["vis_adapter_p1"][b](f_v, f_a, train)
                f_v = attn_state(blk, f_v, dt, train, generator) + f_v_res
                f_a = attn_state(blk, f_a, dt, train, generator) + f_a_res
                f_a_res = ad["audio_adapter_p2"][b](f_a, f_v, train)
                f_v_res = ad["vis_adapter_p2"][b](f_v, f_a, train)
                f_v = mlp_state(blk, f_v, dt, train, generator) + f_v_res
                f_a = mlp_state(blk, f_a, dt, train, generator) + f_a_res
            if stage < len(swin.downsamples):
                f_v = swin.downsamples[stage](f_v.to(dt))
                f_a = swin.downsamples[stage](f_a.to(dt))
        f_v = swin.norm(f_v).to(dt).mean(dim=1)
        f_a = swin.norm(f_a).to(dt).mean(dim=1)
        logits = self.mlp_class_2(self.mlp_class(torch.cat([f_v, f_a], dim=-1).float()))
        return {"event_probs": torch.softmax(logits, dim=-1), "event_logits": logits,
                "telemetry": {}}


# ---------------------------------------------------------------------------
# Launch plans, losses, eval closures
# ---------------------------------------------------------------------------


def mmil_v1_kernel_launches(cfg: AVEConfig) -> Dict[str, int]:
    """K1 / K2 / K3 per forward: every block of both backbones (36 / 36 / 0
    at full width)."""
    return kernel_launches(cfg.swin, cfg.htsat, V1_INJECTION, block_chains=False)


def mmil_v1_backward_launches(cfg: AVEConfig) -> Dict[str, int]:
    """K1b / K2b per train step: the lock-step rule of `backward_launches`
    (34 / 35 at full width: the first site's visual attention sub-block and
    its whole audio block read inputs that need no gradient)."""
    return backward_launches(cfg.swin, cfg.htsat, V1_INJECTION)


def mmil_v2_kernel_launches(cfg: AVEConfig) -> Dict[str, int]:
    """K1 / K2 / K3 per forward: every Swin-V2 block, once a stream (48 / 48
    / 0 at full width)."""
    one = swin_pass_launches(cfg.swin, block_chains=False)
    return {k: 2 * v for k, v in one.items()}


def mmil_v2_backward_launches(cfg: AVEConfig) -> Dict[str, int]:
    """K1b / K2b per train step: every sub-block of both streams but block
    0's attention, whose input is the embedding (46 / 48 at full width)."""
    n = 2 * sum(cfg.swin.depths)
    return {"K1b": n - 2, "K2b": n}


def make_mmil_v1_loss_fn(model: MMILNetV1, mixup_alpha: float = 0.5):
    """Loss closure of a v1 train step: (model, batch, generator) -> (loss,
    aux). loss = `ave_loss` (BCE + 2 CE) + a BCE-with-logits of the
    av_gate outputs (sigmoid values, kept as the reference driver feeds
    them) against the any-foreground labels; accuracy in aux. Without a
    `mixup_lambda` in the batch, λ is drawn per frame from Beta(α, α)."""
    del model

    def loss_fn(model: MMILNetV1, batch: Dict, generator: Gen):
        lam = batch.get("mixup_lambda")
        if lam is None and mixup_alpha > 0 and generator is not None:
            B, T = batch["wave"].shape[0], batch["wave"].shape[1]
            lam = get_mix_lambda(generator, mixup_alpha, B * T, device=batch["wave"].device)
        out = model(batch["wave"], batch["images"], train=True, mixup_lambda=lam,
                    generator=generator)
        loss, aux = ave_loss(out, batch["labels"], 0.0)
        labels_bce, _ = ave_labels(batch["labels"])
        aux["loss_gate"] = binary_cross_entropy_with_logits(out["av_gate"], labels_bce)
        with torch.no_grad():
            aux["accuracy"] = ave_accuracy(out["is_event_logits"], out["event_logits"],
                                           batch["labels"])
        return loss + aux["loss_gate"], aux

    return loss_fn


def _lavish_accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of the B·T segments whose argmax class is the label's."""
    gt = labels.reshape(-1, labels.shape[-1])
    return (probs.argmax(dim=-1) == gt.argmax(dim=-1)).float().mean()


def make_mmil_v2_loss_fn(model: MMILNetV2):
    """Loss closure of a LAVisH train step: the mean sigmoid BCE of the
    SOFTMAXED class scores against the (B·T, cls + 1) one-hot labels, as
    the reference driver computes it; accuracy in aux."""
    del model

    def loss_fn(model: MMILNetV2, batch: Dict, generator: Gen):
        out = model(batch["audio_spec"], batch["images"], train=True, generator=generator)
        gt = batch["labels"].reshape(-1, batch["labels"].shape[-1])
        loss = binary_cross_entropy_with_logits(out["event_probs"].float(), gt)
        with torch.no_grad():
            acc = _lavish_accuracy(out["event_probs"], batch["labels"])
        return loss, {"accuracy": acc}

    return loss_fn


def make_mmil_v1_eval_fn(model: MMILNetV1) -> Callable[[Dict], Dict]:
    def eval_fn(batch: Dict) -> Dict:
        out = model(batch["wave"], batch["images"])
        return {"accuracy": ave_accuracy(out["is_event_logits"], out["event_logits"],
                                         batch["labels"]),
                "telemetry": out["telemetry"]}

    return eval_fn


def make_mmil_v2_eval_fn(model: MMILNetV2) -> Callable[[Dict], Dict]:
    """Accuracy: argmax over the B·T segment rows."""

    def eval_fn(batch: Dict) -> Dict:
        out = model(batch["audio_spec"], batch["images"])
        return {"accuracy": _lavish_accuracy(out["event_probs"], batch["labels"]),
                "telemetry": out["telemetry"]}

    return eval_fn
