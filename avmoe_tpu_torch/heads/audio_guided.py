"""Audio-guided spatial-channel attention (the CMRAN / CMBS lineage): visual
self-attention over the spatial grid, a video-average spatial gate,
audio-guided channel attention and audio-guided spatial pooling; one
attended visual vector per segment.

Counterpart of `avmoe_tpu/heads/audio_guided.py:17` `AudioGuidedAttention`,
same parameter names. Its one dropout (rate 0.2, on the self-attention's
output) draws from an explicit generator in train mode. No model of either
package uses it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import LayerNorm


class AudioGuidedAttention(nn.Module):
    def __init__(self, video_dim: int = 512, audio_dim: int = 128, hidden_dim: int = 256,
                 latent_ratio: int = 4, beta: float = 0.1):
        super().__init__()
        self.beta = beta
        d = video_dim // latent_ratio
        self.video_query = nn.Linear(video_dim, d)
        self.video_key = nn.Linear(video_dim, d)
        self.video_value = nn.Linear(video_dim, video_dim)
        self.norm = LayerNorm(video_dim)
        self.affine_video_ave = nn.Linear(video_dim, hidden_dim)
        self.affine_video_3 = nn.Linear(video_dim, hidden_dim)
        self.ave_v_att = nn.Linear(hidden_dim, 1)
        self.affine_audio_1 = nn.Linear(audio_dim, video_dim)
        self.affine_video_1 = nn.Linear(video_dim, video_dim)
        self.affine_bottleneck = nn.Linear(video_dim, hidden_dim)
        self.affine_v_c_att = nn.Linear(hidden_dim, video_dim)
        self.affine_video_2 = nn.Linear(video_dim, hidden_dim)
        self.affine_audio_2 = nn.Linear(audio_dim, hidden_dim)
        self.affine_v_s_att = nn.Linear(hidden_dim, 1)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video (B, T, H, W, Cv), audio (B, T, Ca) -> (B, T, Cv)."""
        B, T, H, W, Cv = video.shape
        raw = grid = video.reshape(B * T, H * W, Cv)
        a = audio.reshape(B * T, -1)

        # spatial self-attention over the grid (post-norm residual)
        att = torch.softmax(self.video_query(grid) @ self.video_key(grid).transpose(1, 2), -1)
        out = dropout(att @ self.video_value(grid), 0.2, train=train, generator=generator)
        grid = self.norm(grid + out)

        # video-average spatial gate
        avg = F.relu(self.affine_video_ave(grid.mean(dim=1)))[:, None]
        q3 = F.relu(self.affine_video_3(grid))
        self_maps = torch.softmax(torch.tanh(self.ave_v_att(q3 * avg)).transpose(1, 2), -1)
        self_feat = (self_maps @ grid)[:, 0].reshape(B, T, Cv)

        # audio-guided channel attention on the raw grid
        aq1 = F.relu(self.affine_audio_1(a))[:, None]
        vq1 = F.relu(self.affine_video_1(grid))
        bottleneck = F.relu(self.affine_bottleneck((aq1 * vq1).mean(dim=1)))
        c_att = torch.sigmoid(self.affine_v_c_att(bottleneck))[:, None]
        c_feat = raw * (c_att + 1.0)

        # audio-guided spatial pooling
        cq = F.relu(self.affine_video_2(c_feat))
        aq2 = F.relu(self.affine_audio_2(a))[:, None]
        s_maps = torch.softmax(torch.tanh(self.affine_v_s_att(cq * aq2)).transpose(1, 2), -1)
        pooled = (s_maps @ c_feat)[:, 0].reshape(B, T, Cv)
        return pooled + self.beta * torch.sigmoid(self_feat) * pooled
