"""Configuration of the AVE, AVVP, AVQA and AVS models and their training,
as plain frozen dataclasses.

Field names and defaults mirror the JAX package's `avmoe_tpu/config.py` so a
configuration reads the same in both packages. Fields that only select a
TPU memory layout there (`remat`, `remat_policy`, `token_shard_axis`) are not
carried over: the port computes the same function without them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AudioFrontendConfig:
    """Log-mel front-end constants."""

    sample_rate: int = 32_000
    n_fft: int = 1024
    hop_length: int = 320
    win_length: int = 1024
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14_000.0
    amin: float = 1e-10
    ref: float = 1.0
    # SpecAugment (train only; kept so configs compare field by field)
    time_drop_width: int = 64
    time_stripes_num: int = 2
    freq_drop_width: int = 8
    freq_stripes_num: int = 2


@dataclass(frozen=True)
class HTSATConfig:
    """HTS-AT audio Swin transformer (V1 windows)."""

    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ape: bool = False
    patch_norm: bool = True
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.frontend.n_mels

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.spec_size // self.patch_stride[0],
                self.spec_size // self.patch_stride[1])

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


@dataclass(frozen=True)
class SwinV2Config:
    """Swin-V2 vision transformer (timm swinv2_large_window12_192_22k geometry)."""

    img_size: int = 192
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    pretrained_window_sizes: Tuple[int, ...] = (12, 12, 12, 6)

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        r = self.img_size // self.patch_size
        return (r, r)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @staticmethod
    def large() -> "SwinV2Config":
        return SwinV2Config()

    @staticmethod
    def base() -> "SwinV2Config":
        return SwinV2Config(embed_dim=128, num_heads=(4, 8, 16, 32))


@dataclass(frozen=True)
class AdapterConfig:
    """Per-expert adapter knobs."""

    downsample: int = 8
    num_conv_group: int = 2
    num_tokens: int = 32
    use_bn: bool = True
    use_gate: bool = True
    vis_use_gate: bool = True
    before_layernorm: bool = True
    post_layernorm: bool = True
    # the unimodal expert's self-attention: 'none' (AVE, AVQA), 'bmm'
    # (AVVP), 'mha' (AVS S4) or 'token' (AVS MS3)
    self_attention: str = "none"


@dataclass(frozen=True)
class MoEConfig:
    """Router + expert mixture."""

    num_multimodal_experts: int = 1
    num_singlemodal_experts: int = 1
    router_hidden: Tuple[int, int] = (128, 32)
    load_balance_loss: bool = False
    lb_loss_compat: bool = False
    router_noise_std: float = 0.0
    adapter: AdapterConfig = field(default_factory=AdapterConfig)

    @property
    def num_experts(self) -> int:
        return self.num_multimodal_experts + self.num_singlemodal_experts


@dataclass(frozen=True)
class InjectionConfig:
    """Where adapters attach in the lock-step dual-backbone loop."""

    audio_adapter_p1: bool = True
    audio_adapter_p2: bool = True
    num_skip: int = 2


@dataclass(frozen=True)
class AVEConfig:
    """AVE event localization (the flagship)."""

    num_classes: int = 28
    num_segments: int = 10
    audio_len: int = 32_000
    d_model: int = 256
    is_cmbs: bool = True
    is_temporal_att: bool = True
    is_inter_in_cmbs: bool = False
    swin: SwinV2Config = field(default_factory=SwinV2Config)
    htsat: HTSATConfig = field(default_factory=HTSATConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    injection: InjectionConfig = field(default_factory=InjectionConfig)


@dataclass(frozen=True)
class AVVPConfig:
    """AVVP weakly-supervised parsing (the MGN model): adapters in every stage
    (num_skip=1), no BatchNorm in the adapters, bmm self-attention unimodal
    experts, the router's load-balance loss on at the reference's magnitude."""

    num_classes: int = 25
    num_segments: int = 10
    audio_len: int = 32_000
    dim: int = 128
    st_dim: int = 512              # r2plus1d clip features
    depth_aud: int = 3
    depth_vis: int = 3
    depth_av: int = 6
    unimodal_assign: str = "soft"   # 'soft' | 'hard'
    crossmodal_assign: str = "soft"
    swin: SwinV2Config = field(default_factory=SwinV2Config)
    htsat: HTSATConfig = field(default_factory=HTSATConfig)
    moe: MoEConfig = field(default_factory=lambda: MoEConfig(
        load_balance_loss=True, lb_loss_compat=True,
        adapter=AdapterConfig(use_bn=False, self_attention="bmm"),
    ))
    injection: InjectionConfig = field(default_factory=lambda: InjectionConfig(num_skip=1))


@dataclass(frozen=True)
class AVQAConfig:
    """AVQA question answering (MUSIC-AVQA): 2 latent tokens, no output gate
    on the audio adapters (the visual ones keep theirs), 1 cross-modal and 2
    unimodal experts, adapters in every stage, an LSTM question encoder and
    a 50-way answer head evaluated over the 42-word answer vocab."""

    answer_vocab: int = 42
    fc_class: int = 50
    qst_vocab: int = 93
    max_qst_len: int = 30
    word_embed: int = 1536
    qst_hidden: int = 1536
    d_feat: int = 1536
    num_segments: int = 10
    audio_len: int = 32_000
    swin: SwinV2Config = field(default_factory=SwinV2Config)
    htsat: HTSATConfig = field(default_factory=HTSATConfig)
    moe: MoEConfig = field(default_factory=lambda: MoEConfig(
        num_multimodal_experts=1, num_singlemodal_experts=2,
        adapter=AdapterConfig(num_tokens=2, use_gate=False, use_bn=False,
                              num_conv_group=4),
    ))
    injection: InjectionConfig = field(default_factory=lambda: InjectionConfig(num_skip=1))


@dataclass(frozen=True)
class AVSConfig:
    """AVS sound-source segmentation, S4 and MS3: 5 frames a clip at 224 px
    (resized to Swin's 192), adapters in every stage, 'mha' unimodal
    experts, a noisy router with the load-balance loss, TPAVI on all four
    pyramid stages and an FPN decoder to 224-px masks. MS3 is this config
    with the 'token' expert, gamma 0.1 and the masked audio-visual loss."""

    setting: str = "s4"             # 's4' | 'ms3'
    num_segments: int = 5
    audio_len: int = 32_000
    img_size: int = 224             # the frames' size; the model resizes to Swin's
    channel: int = 256              # decoder width
    mask_size: int = 224
    tpavi_stages: Tuple[int, ...] = (0, 1, 2, 3)
    tpavi_vv_flag: bool = False
    tpavi_va_flag: bool = True
    pyramid_sizes: Tuple[int, ...] = (56, 28, 14, 7)
    sa_loss_flag: bool = False
    lambda_1: float = 0.0
    sa_loss_stages: Tuple[int, ...] = ()
    sa_loss_kind: str = "cosine"    # 'cosine' | 'euclidean' | 'kl'
    closer_loss: bool = False
    sa_norm_fea: bool = True
    sa_threshold: bool = True
    lb_loss_weight: float = 0.0
    temporal_gamma: float = 0.05
    swin: SwinV2Config = field(default_factory=SwinV2Config)
    htsat: HTSATConfig = field(default_factory=HTSATConfig)
    # 87 latent tokens on every expert, no BN, no gate on the audio adapters
    # (the visual ones keep theirs)
    moe: MoEConfig = field(default_factory=lambda: MoEConfig(
        load_balance_loss=True, lb_loss_compat=True, router_noise_std=0.01,
        adapter=AdapterConfig(self_attention="mha", use_bn=False,
                              use_gate=False, num_tokens=87),
    ))
    injection: InjectionConfig = field(default_factory=lambda: InjectionConfig(num_skip=1))


@dataclass(frozen=True)
class TrainConfig:
    """Optimization settings, as the JAX package's TrainConfig."""

    batch_size: int = 2
    accum_steps: int = 8
    epochs: int = 50
    lr: float = 5e-4
    lr_mlp: float = 5e-6
    decay: float = 0.35            # StepLR gamma
    decay_epoch: int = 3           # StepLR step size, in epochs
    early_stop: int = 20
    seed: int = 999
    mixup_alpha: float = 0.5
    dtype: str = "float32"         # backbones' compute dtype; the AVE CLI sets it from --bf16


def ave_train_preset() -> Tuple[AVEConfig, TrainConfig]:
    """The AVE recipe's model and training settings."""
    return AVEConfig(), TrainConfig()


# HTS-AT pretrained-checkpoint flavors: (sample_rate, hop_length,
# num_classes, the checkpoint file the converter expects). The geometry
# (spec 256, patch 4, depths 2-2-6-2, width 96) is the same in all three.
HTSAT_BACKBONE_FLAVORS = {
    "esc-50": (32_000, 320, 50, "HTSAT_ESC_exp=1_fold=1_acc=0.985.ckpt"),
    "audioset": (32_000, 320, 527, "HTSAT_AudioSet_Saved_1.ckpt"),
    "scv2": (16_000, 160, 35, "HTSAT_SCV2_Saved_3.ckpt"),
}


def htsat_backbone_preset(backbone_type: str = "audioset") -> Tuple[HTSATConfig, str]:
    """(HTSATConfig, checkpoint file name) of a named HTS-AT flavor."""
    try:
        sr, hop, classes, ckpt = HTSAT_BACKBONE_FLAVORS[backbone_type]
    except KeyError:
        raise NotImplementedError(
            f"backbone_type {backbone_type!r}: expected one of "
            f"{sorted(HTSAT_BACKBONE_FLAVORS)}") from None
    cfg = HTSATConfig(num_classes=classes,
                      frontend=AudioFrontendConfig(sample_rate=sr, hop_length=hop))
    return cfg, ckpt


def swin_model_preset(model_size: str = "large") -> SwinV2Config:
    """Swin-V2 flavor by size: 'large', or 'base' (which the original
    recipe's option calls 'small')."""
    if model_size == "large":
        return SwinV2Config.large()
    if model_size in ("base", "small"):
        return SwinV2Config.base()
    raise NotImplementedError(f"model_size {model_size!r}: expected 'large' or 'base'/'small'")


def ave_flavor_config(backbone_type: str = "audioset",
                      model_size: str = "large") -> Tuple[AVEConfig, str]:
    """AVEConfig with the named backbone flavors, and the HTS-AT checkpoint
    file name."""
    htsat, ckpt = htsat_backbone_preset(backbone_type)
    return dataclasses.replace(AVEConfig(), htsat=htsat,
                               swin=swin_model_preset(model_size)), ckpt


def replace(cfg, **kwargs):
    """Functional config update."""
    return dataclasses.replace(cfg, **kwargs)


def _tiny_frontend() -> AudioFrontendConfig:
    return AudioFrontendConfig(
        sample_rate=4000, n_fft=256, hop_length=125, win_length=256,
        n_mels=16, fmin=50.0, fmax=1800.0,
        time_drop_width=8, time_stripes_num=2, freq_drop_width=2, freq_stripes_num=2,
    )


def tiny_htsat() -> HTSATConfig:
    """Miniature HTS-AT: same stage structure, tiny widths."""
    return HTSATConfig(
        spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
        depths=(2, 2, 6, 2), num_heads=(2, 2, 2, 2), window_size=4,
        drop_path_rate=0.0, frontend=_tiny_frontend(),
    )


def tiny_swin() -> SwinV2Config:
    return SwinV2Config(
        img_size=64, patch_size=4, embed_dim=16, depths=(2, 2, 18, 2),
        num_heads=(2, 2, 2, 2), window_size=4, drop_path_rate=0.0,
        pretrained_window_sizes=(0, 0, 0, 0),
    )


def tiny_ave_config() -> AVEConfig:
    return AVEConfig(
        num_segments=2,
        audio_len=4000,
        d_model=32,
        swin=tiny_swin(),
        htsat=tiny_htsat(),
        moe=MoEConfig(adapter=AdapterConfig(downsample=4, num_conv_group=2, num_tokens=8)),
    )


def tiny_avvp_config() -> AVVPConfig:
    return AVVPConfig(
        num_segments=2,
        audio_len=4000,
        dim=32,
        st_dim=16,
        depth_aud=1, depth_vis=1, depth_av=1,
        swin=tiny_swin(),
        htsat=tiny_htsat(),
        moe=MoEConfig(
            load_balance_loss=True, lb_loss_compat=True,
            adapter=AdapterConfig(downsample=4, num_conv_group=2, num_tokens=8,
                                  use_bn=False, self_attention="bmm"),
        ),
        injection=InjectionConfig(num_skip=1),
    )


def tiny_avqa_config() -> AVQAConfig:
    return AVQAConfig(
        answer_vocab=6, fc_class=8, qst_vocab=20, max_qst_len=6,
        word_embed=16, qst_hidden=16, d_feat=128,  # == tiny swin num_features
        num_segments=2, audio_len=4000,
        swin=tiny_swin(), htsat=tiny_htsat(),
        moe=MoEConfig(
            num_multimodal_experts=1, num_singlemodal_experts=2,
            adapter=AdapterConfig(downsample=4, num_conv_group=2, num_tokens=2,
                                  use_gate=False, use_bn=False),
        ),
        injection=InjectionConfig(num_skip=1),
    )


def tiny_avs_config() -> AVSConfig:
    return AVSConfig(
        num_segments=2,
        audio_len=4000,
        img_size=64,
        channel=32,
        mask_size=64,
        pyramid_sizes=(16, 8, 4, 2),
        swin=tiny_swin(),
        htsat=tiny_htsat(),
        moe=MoEConfig(
            load_balance_loss=True, lb_loss_compat=True, router_noise_std=0.01,
            adapter=AdapterConfig(downsample=4, num_conv_group=2, num_tokens=87,
                                  self_attention="mha", use_bn=False, use_gate=False),
        ),
        injection=InjectionConfig(num_skip=1),
    )


# "mini" configs: the tiny widths at the datasets' real clip geometry (10
# one-second segments at 32 kHz)


def _mini_frontend() -> AudioFrontendConfig:
    # 32k samples / hop 1000: the same 32-frame x 16-mel spectrogram as the
    # tiny front end, so tiny_htsat()'s geometry holds unchanged
    return AudioFrontendConfig(
        sample_rate=32000, n_fft=1024, hop_length=1000, win_length=1024,
        n_mels=16, fmin=50.0, fmax=14000.0,
        time_drop_width=8, time_stripes_num=2, freq_drop_width=2,
        freq_stripes_num=2,
    )


def _mini_htsat() -> HTSATConfig:
    return dataclasses.replace(tiny_htsat(), frontend=_mini_frontend())


def mini_ave_config() -> AVEConfig:
    return dataclasses.replace(tiny_ave_config(), num_segments=10, audio_len=32000,
                               htsat=_mini_htsat())


def mini_avvp_config() -> AVVPConfig:
    return dataclasses.replace(tiny_avvp_config(), num_segments=10, audio_len=32000,
                               htsat=_mini_htsat())


def mini_avqa_config() -> AVQAConfig:
    # vocab sizes of the miniature MUSIC-AVQA json; max_qst_len is the
    # reader's fixed pad length
    return dataclasses.replace(tiny_avqa_config(), num_segments=10, audio_len=32000,
                               max_qst_len=14, qst_vocab=64, answer_vocab=6,
                               htsat=_mini_htsat())


def mini_avs_config() -> AVSConfig:
    return dataclasses.replace(tiny_avs_config(), num_segments=5, audio_len=32000,
                               htsat=_mini_htsat())


def ms3_config(cfg: AVSConfig) -> AVSConfig:
    """The MS3 recipe over an AVS config: the 'token' expert, gamma 0.1, the
    load-balance loss at 0.01 and the KL masked audio-visual loss at lambda
    0.5 over all four stages, soft masks, unnormed features."""
    return dataclasses.replace(
        cfg, setting="ms3", temporal_gamma=0.1, lb_loss_weight=0.01, sa_loss_flag=True,
        lambda_1=0.5, sa_loss_kind="kl", sa_norm_fea=False, sa_threshold=False,
        sa_loss_stages=(0, 1, 2, 3),
        moe=dataclasses.replace(cfg.moe, adapter=dataclasses.replace(
            cfg.moe.adapter, self_attention="token")))
