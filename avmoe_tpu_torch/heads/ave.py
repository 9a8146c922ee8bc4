"""AVE task head: temporal attention + CMBS localization.

Counterpart of `avmoe_tpu/heads/ave.py`. `AudioVideoInter` is the CMBS
interaction block of `is_inter_in_cmbs=True`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.heads.common import (BiLSTM, MultiHeadAttention, TransformerDecoder,
                                           TransformerEncoder)
from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import LayerNorm


class TemporalAttention(nn.Module):
    """(B, T, C_v), (B, T, C_a) -> gated (B, T, d_model) per modality and
    the (B, T, 1) audio-visual gate."""

    def __init__(self, video_input_dim: int = 1536, audio_input_dim: int = 768,
                 d_model: int = 256, video_fc_dim: int = 512, audio_fc_dim: int = 128,
                 gamma: float = 0.1):
        super().__init__()
        self.gamma = gamma
        self.a_fc = nn.Linear(audio_input_dim, audio_fc_dim)
        self.v_fc = nn.Linear(video_input_dim, video_fc_dim)
        self.audio_rnn = BiLSTM(audio_fc_dim, d_model // 2)
        self.visual_rnn = BiLSTM(video_fc_dim, d_model)
        self.video_enc_affine = nn.Linear(2 * d_model, d_model)
        self.video_encoder = TransformerEncoder(d_model, 4, 2, 1024)
        self.audio_enc_affine = nn.Linear(d_model, d_model)
        self.audio_encoder = TransformerEncoder(d_model, 4, 2, 1024)
        self.audio_dec_affine = nn.Linear(d_model, d_model)
        self.audio_decoder = TransformerDecoder(d_model, 4, 1, 1024)
        self.video_dec_affine = nn.Linear(2 * d_model, d_model)
        self.video_decoder = TransformerDecoder(d_model, 4, 1, 1024)
        self.audio_gated = nn.Linear(d_model, 1)
        self.video_gated = nn.Linear(d_model, 1)

    def forward(self, visual: torch.Tensor, audio: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        audio = self.a_fc(audio)
        visual = dropout(F.relu(self.v_fc(visual)), 0.2, train=train, generator=generator)
        audio_rnn = self.audio_rnn(audio)
        visual_rnn = self.visual_rnn(visual)
        video_kv = self.video_encoder(self.video_enc_affine(visual_rnn), train, generator)
        audio_kv = self.audio_encoder(self.audio_enc_affine(audio_rnn), train, generator)
        audio_q = self.audio_decoder(self.audio_dec_affine(audio_rnn), video_kv, train,
                                     generator)
        video_q = self.video_decoder(self.video_dec_affine(visual_rnn), audio_kv, train,
                                     generator)
        audio_gate = torch.sigmoid(self.audio_gated(audio_kv))
        video_gate = torch.sigmoid(self.video_gated(video_kv))
        video_q = video_q + audio_gate * video_q * self.gamma
        audio_q = audio_q + video_gate * audio_q * self.gamma
        return video_q, audio_q, audio_gate * video_gate


class WeaklyLocalizationModule(nn.Module):
    """fused (B, T, C) -> (is_event (B, T), raw_logits (B, cls+1),
    event_scores (B, cls+1))."""

    def __init__(self, d_model: int, num_classes: int = 28):
        super().__init__()
        self.classifier = nn.Linear(d_model, 1)
        self.event_classifier = nn.Linear(d_model, num_classes + 1)

    def forward(self, fused: torch.Tensor):
        is_event = self.classifier(fused)[..., 0]
        raw_logits = self.event_classifier(fused.amax(dim=1))
        fused_logits = torch.sigmoid(is_event)[..., None] * raw_logits[:, None]
        return is_event, raw_logits, torch.softmax(fused_logits.amax(dim=1), dim=-1)


class AudioVideoInter(nn.Module):
    """CMBS interaction block: the query video * audio attends over
    concat([audio, video]) (attention-weight dropout 0.2), then dropout 0.1
    on the residual branch and a LayerNorm with eps 1e-5."""

    def __init__(self, d_model: int, n_head: int = 4):
        super().__init__()
        self.mha = MultiHeadAttention(d_model, n_head)
        self.norm1 = LayerNorm(d_model, eps=1e-5)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        global_feat = video * audio
        memory = torch.cat([audio, video], dim=1)
        mid = self.mha(global_feat, memory, rate=0.2, train=train, generator=generator)
        return self.norm1(global_feat + dropout(mid, 0.1, train=train, generator=generator))


class CMBSHead(nn.Module):
    """CAS top-k scoring + supervised localization: (B, T, d_model) x 2 ->
    (is_event_logits (B, T), event_logits (B, cls), av_score (B, cls)).
    With `inter`, the two streams pass through `AudioVideoInter` blocks
    (av_inter, va_inter) after the CAS scores."""

    def __init__(self, num_classes: int = 28, d_model: int = 256, topk: int = 4,
                 gamma: float = 0.3, inter: bool = False):
        super().__init__()
        self.topk, self.gamma = topk, gamma
        self.video_cas = nn.Linear(d_model, num_classes)
        self.audio_cas = nn.Linear(d_model, num_classes)
        if inter:
            self.av_inter = AudioVideoInter(d_model)
            self.va_inter = AudioVideoInter(d_model)
        self.inter = inter
        self.classifier = nn.Linear(d_model, 1)
        self.event_classifier = nn.Linear(d_model, num_classes)

    def forward(self, visual: torch.Tensor, audio: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        video_cas = self.video_cas(visual)
        audio_cas = self.audio_cas(audio)
        k = min(self.topk, video_cas.shape[1])
        score_video = torch.topk(video_cas.transpose(1, 2), k, dim=-1).values.mean(-1)
        score_audio = torch.topk(audio_cas.transpose(1, 2), k, dim=-1).values.mean(-1)
        av_score = (score_video + score_audio) / 2.0
        if self.inter:
            visual, audio = (self.av_inter(visual, audio, train, generator),
                             self.va_inter(audio, visual, train, generator))
        fused = (visual + audio) / 2.0
        is_event_logits = self.classifier(fused)[..., 0]
        event_logits = self.event_classifier(fused.amax(dim=1)) + self.gamma * av_score
        return is_event_logits, event_logits, av_score
