"""AVQA: audio-visual question answering, the fusion model.

Counterpart of `avmoe_tpu/models/avqa.py`. The lock-step encoder with MoE
adapters in every stage over the positive frames; the negative frames
through the frozen Swin-V2 alone (no adapters, eval mode, no gradient); an
LSTM question encoder; audio-guided grounding on the final visual token
grid with positive / negative matching heads; question-as-query attention
over the T segments; answer logits:

  posi frames + wave -> encoder.forward_tokens -> f_v grid, f_a tokens
  nega frames -> swin.forward_features (frozen)  -> f_v_nega grid
  f_a (token mean) -> fc_a1 ReLU fc_a2 -> audio feat a
  ground(a, grid) = fc_gl(tanh([mean(grid), softmax(v . a) v]))  (v, a unit rows)
  match(a, grounded) = fc1 ReLU fc2 ReLU fc3 ReLU fc4              (B*T, 2)
  question -> QstEncoder -> q; attn_v(q, grounded posi), attn_a(q, a)
  fc_ans(tanh(fc_fusion(tanh([a_att + mean a, v_att + mean v])) * q))

Inputs are batch-first and channels-last, as in the JAX package:

  wave         (B, T, L)        raw waveform segments
  visual_posi  (B, T, H, W, 3)  normalized RGB frames of the clip
  visual_nega  (B, T, H, W, 3)  frames of another clip
  question     (B, Lq)          int token ids, padded

and the output dict holds qa_logits (B, fc_class), match_posi / match_nega
(B*T, 2) and telemetry (per-site gating probs, the summed lb_loss).

The encoder runs in the model's compute dtype; its outputs enter the heads
as float32. `forward(..., train=False)` is the eval forward under
torch.no_grad; `forward(..., train=True, mixup_lambda=..., generator=...)`
the train forward (default path only), which draws dropout and SpecAugment
from `generator` and mixes the audio with the given per-frame λ.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch import resolve_device
from avmoe_tpu_torch.audio.frontend import get_mix_lambda
from avmoe_tpu_torch.config import AVQAConfig
from avmoe_tpu_torch.heads.common import LSTMCell, MultiHeadAttention
from avmoe_tpu_torch.losses.classification import cross_entropy_with_logits
from avmoe_tpu_torch.metrics.avqa import AVQAAccuracy
from avmoe_tpu_torch.models.ave import init_parameters
from avmoe_tpu_torch.moe.injection import LockstepEncoder, kernel_launches, swin_pass_launches
from avmoe_tpu_torch.ops.dropout import dropout
from avmoe_tpu_torch.ops.norm import LayerNorm

Gen = Optional[torch.Generator]


class QstEncoder(nn.Module):
    """Embedding, tanh, a one-way LSTM over the whole padded question (no
    length masking), tanh([last h, last c]), fc."""

    def __init__(self, vocab: int, word_embed: int, hidden: int, embed_size: int):
        super().__init__()
        self.word2vec = nn.Embedding(vocab, word_embed)
        self.lstm = LSTMCell(word_embed, hidden)
        self.fc = nn.Linear(2 * hidden, embed_size)

    def forward(self, question: torch.Tensor) -> torch.Tensor:
        emb = torch.tanh(self.word2vec(question.long()))
        _, (h, c) = self.lstm(emb, return_carry=True)
        return self.fc(torch.tanh(torch.cat([h, c], dim=-1)))


class _QueryAttentionFFN(nn.Module):
    """4-head attention with the question as the single query, then
    linear1 ReLU linear2 as a residual, then LayerNorm (eps 1e-5); dropout
    0.1 on the attention weights, after the ReLU and on the residual."""

    RATE = 0.1

    def __init__(self, dim: int):
        super().__init__()
        self.attn = MultiHeadAttention(dim, 4)
        self.linear1 = nn.Linear(dim, dim)
        self.linear2 = nn.Linear(dim, dim)
        self.norm = LayerNorm(dim)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, train: bool = False,
                generator: Gen = None) -> torch.Tensor:
        """q (B, C), kv (B, T, C) -> (B, C)."""
        drop = lambda t: dropout(t, self.RATE, train=train, generator=generator)
        att = self.attn(q[:, None, :], kv, rate=self.RATE, train=train,
                        generator=generator)[:, 0]
        src = self.linear2(drop(F.relu(self.linear1(att))))
        return self.norm(att + drop(src))


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)


class AVQAFusionModel(nn.Module):
    def __init__(self, cfg: AVQAConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: Optional[int] = 0, block_chains: bool = False,
                 fused_moe: bool = False, fused_moe_train: bool = False):
        """Build on `device` (default the card; raises if it is absent) and,
        unless seed is None, initialize the parameters from `seed`.
        `block_chains` runs the backbones' blocks, the frozen negative pass's
        too, through K3 chains (eval only, `moe/injection.py`). `fused_moe` / `fused_moe_train`
        take the adapters' fused combine in eval / train (`moe/adapter.py`)."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c, d = cfg, cfg.d_feat
        if c.swin.num_features != d:
            raise ValueError(f"grounding needs d_feat == the Swin width, got {d} and "
                             f"{c.swin.num_features}")
        with torch.device(dev):
            self.encoder = LockstepEncoder(c.swin, c.htsat, c.moe, c.injection, dtype=dtype,
                                           block_chains=block_chains,
                                           fused_moe=fused_moe, fused_moe_train=fused_moe_train)
            self.fc_a1 = nn.Linear(c.htsat.num_features, d)
            self.fc_a2 = nn.Linear(d, d)
            self.fc_gl = nn.Linear(2 * d, d)
            self.fc_fusion = nn.Linear(2 * d, d)
            self.fc1 = nn.Linear(2 * d, 512)
            self.fc2 = nn.Linear(512, 256)
            self.fc3 = nn.Linear(256, 128)
            self.fc4 = nn.Linear(128, 2)
            self.question_encoder = QstEncoder(c.qst_vocab, c.word_embed, c.qst_hidden, d)
            self.attn_v = _QueryAttentionFFN(d)
            self.attn_a = _QueryAttentionFFN(d)
            self.fc_ans = nn.Linear(d, c.fc_class)
        self.match_mlp = [self.fc1, self.fc2, self.fc3, self.fc4]
        self.to(dev)
        self.eval()
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            init_parameters(self, gen)

    def ground(self, audio_feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        """Audio-guided spatial grounding: audio_feat (B', C), grid (B', P, C)
        -> (B', C). The mean pools the grid as it is, the attention the unit
        rows."""
        before = grid.mean(dim=1)
        v, a = _unit_rows(grid), _unit_rows(audio_feat)
        att = torch.softmax(torch.einsum("bpc,bc->bp", v, a), dim=-1)
        after = torch.einsum("bp,bpc->bc", att, v)
        return self.fc_gl(torch.tanh(torch.cat([before, after], dim=-1)))

    def match(self, audio_feat: torch.Tensor, visual_grd: torch.Tensor) -> torch.Tensor:
        feat = torch.cat([audio_feat, visual_grd], dim=-1)
        for i, layer in enumerate(self.match_mlp):
            feat = layer(feat)
            if i < len(self.match_mlp) - 1:
                feat = F.relu(feat)
        return feat

    def negative_features(self, frames: torch.Tensor) -> torch.Tensor:
        """(B', H, W, 3) -> (B', N_last, C): the frozen Swin-V2 alone, in eval
        mode and without gradient, through K3 chains on the chain path."""
        swin = self.encoder.swin
        with torch.no_grad():
            return swin.forward_features(swin.embed(frames), chains=self.encoder.block_chains)

    def forward(self, wave: torch.Tensor, visual_posi: torch.Tensor,
                visual_nega: torch.Tensor, question: torch.Tensor, *, train: bool = False,
                mixup_lambda: Optional[torch.Tensor] = None, generator: Gen = None) -> Dict:
        if not train:
            with torch.no_grad():
                return self._forward(wave, visual_posi, visual_nega, question, False, None, None)
        return self._forward(wave, visual_posi, visual_nega, question, True, mixup_lambda,
                             generator)

    def _forward(self, wave, visual_posi, visual_nega, question, train: bool, mixup_lambda,
                 generator) -> Dict:
        B, T = wave.shape[0], wave.shape[1]
        frames = lambda x: x.reshape((B * T,) + tuple(x.shape[2:]))
        f_v_grid, f_a_tokens, telemetry = self.encoder.forward_tokens(
            wave.reshape(B * T, -1), frames(visual_posi), train=train,
            mixup_lambda=mixup_lambda, generator=generator)
        f_v_grid = f_v_grid.float()
        f_v_nega = self.negative_features(frames(visual_nega)).float()
        f_a = f_a_tokens.float().mean(dim=1)                       # (B*T, C_a)

        audio_feat = self.fc_a2(F.relu(self.fc_a1(f_a.reshape(B, T, -1))))   # (B, T, d)
        audio_flat = audio_feat.reshape(B * T, -1)
        visual_grd_posi = self.ground(audio_flat, f_v_grid)
        visual_grd_nega = self.ground(audio_flat, f_v_nega)
        out_match_posi = self.match(audio_flat, visual_grd_posi)
        out_match_nega = self.match(audio_flat, visual_grd_nega)

        qst = self.question_encoder(question)                     # (B, d)
        v_seq = visual_grd_posi.reshape(B, T, -1)
        v_att = self.attn_v(qst, v_seq, train, generator)
        a_att = self.attn_a(qst, audio_feat, train, generator)
        feat = torch.cat([a_att + audio_feat.mean(dim=1), v_att + v_seq.mean(dim=1)], dim=-1)
        feat = self.fc_fusion(torch.tanh(feat))
        out_qa = self.fc_ans(torch.tanh(feat * qst))
        return {"qa_logits": out_qa, "match_posi": out_match_posi,
                "match_nega": out_match_nega, "telemetry": telemetry}


def avqa_kernel_launches(cfg: AVQAConfig, block_chains: bool) -> Dict[str, int]:
    """Launches of K1, K2 and K3 per forward: the lock-step encoder's and
    the frozen negative pass's."""
    enc = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains)
    neg = swin_pass_launches(cfg.swin, block_chains)
    return {k: enc[k] + neg[k] for k in enc}


def avqa_loss(out: Dict, answer: torch.Tensor, answer_vocab: int, match_weight: float = 0.5
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE(answer) + match_weight * CE(match): the match logits of the
    positive rows (label 1) and then the negative ones (label 0). The
    accuracy (percent) is the argmax over the first `answer_vocab` logits."""
    loss_qa = cross_entropy_with_logits(out["qa_logits"], answer)
    posi, nega = out["match_posi"], out["match_nega"]
    labels = torch.cat([torch.ones(posi.shape[0], dtype=torch.long, device=posi.device),
                        torch.zeros(nega.shape[0], dtype=torch.long, device=nega.device)])
    loss_match = cross_entropy_with_logits(torch.cat([posi, nega], dim=0), labels)
    with torch.no_grad():
        pred = out["qa_logits"][:, :answer_vocab].argmax(dim=-1)
        acc = (pred == answer.long()).float().mean() * 100.0
    return loss_qa + match_weight * loss_match, {
        "loss_qa": loss_qa, "loss_match": loss_match, "accuracy": acc}


def make_avqa_loss_fn(model: AVQAFusionModel, match_weight: float = 0.5):
    """Loss closure of a train step: (model, batch, generator) -> (loss, aux).
    Without a `mixup_lambda` in the batch, λ is drawn per frame from
    Beta(0.5, 0.5), as the JAX loss draws it from the step's 'mixup' stream."""
    answer_vocab = model.cfg.answer_vocab

    def loss_fn(model: AVQAFusionModel, batch: Dict, generator: Gen):
        lam = batch.get("mixup_lambda")
        if lam is None and generator is not None:
            B, T = batch["wave"].shape[0], batch["wave"].shape[1]
            lam = get_mix_lambda(generator, 0.5, B * T, device=batch["wave"].device)
        out = model(batch["wave"], batch["visual_posi"], batch["visual_nega"],
                    batch["question"], train=True, mixup_lambda=lam, generator=generator)
        return avqa_loss(out, batch["answer"], answer_vocab, match_weight)

    return loss_fn


def make_avqa_eval_fn(model: AVQAFusionModel) -> Callable:
    """Eval closure eval_fn(batch, accuracy) -> {"telemetry": ...}: the eval
    forward, the predicted answers (argmax over the answer vocab) into the
    `AVQAAccuracy` with batch["answer"] and the question types
    batch["qtype_str"]."""
    answer_vocab = model.cfg.answer_vocab

    def eval_fn(batch: Dict, accuracy: AVQAAccuracy) -> Dict:
        out = model(batch["wave"], batch["visual_posi"], batch["visual_nega"], batch["question"])
        pred = out["qa_logits"][:, :answer_vocab].argmax(dim=-1).cpu().numpy()
        accuracy.update(pred, np.asarray(torch.as_tensor(batch["answer"]).cpu()),
                        list(batch["qtype_str"]))
        return {"telemetry": out["telemetry"]}

    return eval_fn
