"""DG-SCT single adapter: the pre-MoE generation of the AVE model (MMIL_Net v1).

Counterpart of `avmoe_tpu/moe/dgsct_adapter.py`: one cross-modal adapter
with dual guidance,

  other modality -> token / channel projection -> latent-token cross
  attention into x -> channel attention (SE-style, audio-guided) -> spatial
  attention -> x * (alpha c_att + beta s_att + 1 - alpha) -> bottleneck.

Dtypes follow the JAX module's at a compute dtype `dtype`: the projection,
the latent tokens and the bottleneck compute in it; the latent-token
logits over x in x's dtype promoted with it; the gate_av residual, the
channel and spatial attention (flax Dense layers without a dtype), both
LayerNorms and the gate in float32. So a bfloat16 adapter returns float32,
as the JAX one does, and the stream it is added to becomes float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.config import AdapterConfig
from avmoe_tpu_torch.moe.adapter import _Bottleneck, project_tokens
from avmoe_tpu_torch.ops.norm import LayerNorm


class DGSCTAdapter(nn.Module):
    """forward(x (B, N, C), other (B, M, C_other), train) -> (out (B, N, C),
    s_maps (B, 1, N)): s_maps is the softmax over the tokens of
    tanh(spatial-attention logits), which MMIL_Net v1 pools its last
    features with."""

    def __init__(self, dim: int, other_dim: int, num_tokens: int, other_num_tokens: int,
                 cfg: AdapterConfig, dtype: torch.dtype = torch.float32,
                 alpha: float = 0.3, beta: float = 0.05):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.alpha, self.beta = alpha, beta
        self.token_proj_kernel = nn.Parameter(torch.zeros(num_tokens, other_num_tokens))
        self.token_proj_bias = nn.Parameter(torch.zeros(num_tokens))
        self.fc = nn.Linear(other_dim, dim)
        self.latent_tokens = nn.Parameter(torch.zeros(cfg.num_tokens, dim))
        self.gate_av = nn.Parameter(torch.zeros(1))
        self.fc_affine_audio_1 = nn.Linear(dim, dim)
        self.fc_affine_video_1 = nn.Linear(dim, dim)
        self.fc_affine_bottleneck = nn.Linear(dim, dim // 2)
        self.fc_affine_v_c_att = nn.Linear(dim // 2, dim)
        self.fc_affine_video_2 = nn.Linear(dim, dim // 2)
        self.fc_affine_audio_2 = nn.Linear(dim, dim // 2)
        self.fc_affine_v_s_att = nn.Linear(dim // 2, 1)
        if cfg.before_layernorm:
            self.ln_before = LayerNorm(dim)
        self.bottleneck = _Bottleneck(dim, cfg, use_activation=True, num=None)
        if cfg.post_layernorm:
            self.ln_post = LayerNorm(dim)
        if cfg.use_gate:
            self.gate = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, other: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        B, N, C = x.shape
        ot = project_tokens(other.to(dt), self.token_proj_kernel, self.token_proj_bias,
                            self.fc.weight.t(), self.fc.bias)          # (B, N, C)

        # latent-token cross attention: the tokens read the projected other
        # modality, then x reads the tokens
        rep = self.latent_tokens.to(dt)[None].expand(B, -1, -1)
        a1 = torch.softmax(torch.einsum("btc,bmc->btm", rep, ot), dim=-1)
        rep = rep + torch.einsum("btm,bmc->btc", a1, ot)
        pd = torch.promote_types(x.dtype, dt)
        rep = rep.to(pd)
        a2 = torch.softmax(torch.einsum("bnc,btc->bnt", x.to(pd), rep), dim=-1)
        x = x + self.gate_av * torch.einsum("bnt,btc->bnc", a2, rep)  # float32 from here

        # channel attention, audio-guided
        audio = ot.mean(dim=1).float()                                # (B, C)
        aq1 = F.relu(self.fc_affine_audio_1(audio))[:, None]
        vq1 = F.relu(self.fc_affine_video_1(x))
        avq = F.relu(self.fc_affine_bottleneck((aq1 * vq1).mean(dim=1)))
        c_att = torch.sigmoid(self.fc_affine_v_c_att(avq))[:, None]   # (B, 1, C)
        c_feat = x * (c_att + 1.0)

        # spatial attention
        cq = F.relu(self.fc_affine_video_2(c_feat))
        aq2 = F.relu(self.fc_affine_audio_2(audio))[:, None]
        s_logits = self.fc_affine_v_s_att(cq * aq2)                   # (B, N, 1)
        s_maps = torch.softmax(torch.tanh(s_logits).transpose(1, 2), dim=-1)

        x = x * (self.alpha * c_att + self.beta * torch.sigmoid(s_logits) + 1.0 - self.alpha)
        if self.cfg.before_layernorm:
            x = self.ln_before(x)
        out = self.bottleneck(x.to(dt), train)
        if self.cfg.post_layernorm:
            out = self.ln_post(out.float())
        if self.cfg.use_gate:
            out = self.gate * out
        return out, s_maps
