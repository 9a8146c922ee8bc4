"""Flax-layout variable trees written out as the reference's torch state dicts.

The inverse of each converter in `avmoe_tpu_torch/checkpoint/convert.py`
(and so of `avmoe_tpu/checkpoint/convert.py`): given the nested {name:
ndarray} tree of a backbone or a task model, these functions give the state
dict, in the reference's key names and torch layouts, that the converter
maps back onto that tree. With `dropped=True` they also write keys of
reference modules that no converter reads (timm's classifier head, HTS-AT's
spectrogram extractors and position-index buffers, the temporal decoder's
unused self-attention), as a real checkpoint holds them. The HTS-AT tail
that the AVE tree lacks (`norm`, and `tscam_conv` / `head` with
`dropped=True`) is written with fixed values.

`seeded_variables` fills a tree's shapes with seeded noise at each leaf's
role's scale. numpy only: the chip smoke test imports this module to make a
full-width checkpoint on a machine without JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np

SD = Dict[str, np.ndarray]


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _prefixed(prefix: str, sd: Mapping) -> SD:
    return {prefix + k: v for k, v in sd.items()}


def _linear(sd: SD, name: str, kernel, bias=None) -> None:
    sd[f"{name}.weight"] = _f32(np.asarray(kernel).T)
    if bias is not None:
        sd[f"{name}.bias"] = _f32(bias)


def _dense(sd: SD, name: str, tree: Mapping) -> None:
    _linear(sd, name, tree["kernel"], tree.get("bias"))


def _ln(sd: SD, name: str, tree: Mapping) -> None:
    sd[f"{name}.weight"] = _f32(tree["scale"])
    sd[f"{name}.bias"] = _f32(tree["bias"])


def _bn(sd: SD, name: str, params: Mapping, stats: Mapping) -> None:
    _ln(sd, name, params)
    sd[f"{name}.running_mean"] = _f32(stats["mean"])
    sd[f"{name}.running_var"] = _f32(stats["var"])


def _conv(sd: SD, name: str, tree: Mapping) -> None:
    """flax (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)."""
    sd[f"{name}.weight"] = _f32(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in tree:
        sd[f"{name}.bias"] = _f32(tree["bias"])


def _mha(sd: SD, name: str, tree: Mapping) -> None:
    """flax MultiHeadDotProductAttention -> torch nn.MultiheadAttention."""
    D = tree["query"]["kernel"].shape[0]
    sd[f"{name}.in_proj_weight"] = _f32(np.concatenate(
        [np.asarray(tree[n]["kernel"]).reshape(D, -1).T for n in ("query", "key", "value")]))
    sd[f"{name}.in_proj_bias"] = _f32(np.concatenate(
        [np.asarray(tree[n]["bias"]).reshape(-1) for n in ("query", "key", "value")]))
    sd[f"{name}.out_proj.weight"] = _f32(np.asarray(tree["out"]["kernel"]).reshape(-1, D).T)
    sd[f"{name}.out_proj.bias"] = _f32(tree["out"]["bias"])


def _lstm_dir(sd: SD, name: str, cell: Mapping, suffix: str) -> None:
    """A flax cell's eight Dense gates -> torch LSTM weights; the bias is
    split in halves between bias_ih and bias_hh (exact: their sum is it)."""
    sd[f"{name}.weight_ih_l0{suffix}"] = _f32(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in "ifgo"]))
    sd[f"{name}.weight_hh_l0{suffix}"] = _f32(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in "ifgo"]))
    half = _f32(np.concatenate([cell[f"h{g}"]["bias"] for g in "ifgo"])) * np.float32(0.5)
    sd[f"{name}.bias_ih_l0{suffix}"] = half
    sd[f"{name}.bias_hh_l0{suffix}"] = half.copy()


def _bilstm(sd: SD, name: str, tree: Mapping) -> None:
    _lstm_dir(sd, name, tree["fwd_cell"], "")
    _lstm_dir(sd, name, tree["bwd_cell"], "_reverse")


def _noise(path, shape, rng: np.random.Generator) -> np.ndarray:
    name = path[-1]
    n = lambda: rng.standard_normal(shape, dtype=np.float32)
    if path[0] == "batch_stats":
        if "bn0" in path:                  # per-mel-bin stats of log-mel dB values
            return -30.0 + 5.0 * n() if name == "mean" else 200.0 + 50.0 * np.abs(n())
        return 0.1 * n() if name == "mean" else 0.5 + 0.2 * np.abs(n())
    if name in ("gate", "gate_av", "gate_self"):
        return 0.5 + 0.2 * n()
    if name == "scale":
        return 1.0 + 0.1 * n()
    if name == "latent_tokens":
        return rng.random(shape, dtype=np.float32)
    if name == "logit_scale":
        return np.float32(np.log(10.0)) + 0.3 * n()
    if name == "token_proj_kernel":
        return n() / np.sqrt(shape[-1])
    if name in ("kernel", "qkv_kernel", "fc_kernel"):
        if path[-2] == "out" and len(shape) >= 3:          # MHA (H, D, C)
            fan_in = shape[-3] * shape[-2]
        elif path[-2] in ("query", "key", "value"):         # MHA (C, H, D)
            fan_in = shape[-3]
        elif len(shape) == 4 and "bottleneck" not in path:  # conv HWIO
            fan_in = shape[0] * shape[1] * shape[2]
        else:                                               # Dense, grouped
            fan_in = shape[-2]
        return n() / np.float32(np.sqrt(fan_in))
    return 0.1 * n()                                        # biases


def seeded_variables(tree: Mapping, seed: int) -> Dict:
    """Seeded float32 noise shaped like a flax-layout variable tree (its
    leaves: arrays or anything with a shape): adapter gates near 0.5, norm
    scales near 1, kernels at 1 / sqrt(fan-in), HTS-AT bn0's running stats
    those of log-mel dB values."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if hasattr(node, "shape") and not isinstance(node, Mapping):
            return _noise(path, tuple(node.shape), rng).astype(np.float32)
        return {k: walk(node[k], path + (k,)) for k in sorted(node)}

    return walk({k: v for k, v in tree.items() if v}, ())


def _blocks(params: Mapping):
    """(stage, index, subtree) of every block_{s}_{i}, in order."""
    keys = [k for k in params if re.fullmatch(r"block_\d+_\d+", k)]
    for k in sorted(keys, key=lambda k: tuple(int(x) for x in k.split("_")[1:])):
        s, i = (int(x) for x in k.split("_")[1:])
        yield s, i, params[k]


def _patch_embed(sd: SD, tree: Mapping) -> None:
    _conv(sd, "patch_embed.proj", tree["proj"])
    if "norm" in tree:
        _ln(sd, "patch_embed.norm", tree["norm"])


# ---------------------------------------------------------------- backbones


def swinv2_timm_state_dict(params: Mapping, dropped: bool = False) -> SD:
    """SwinV2Encoder params -> a timm SwinTransformerV2 state dict."""
    sd: SD = {}
    _patch_embed(sd, params["patch_embed"])
    for s, i, b in _blocks(params):
        src = f"layers.{s}.blocks.{i}"
        _ln(sd, f"{src}.norm1", b["norm1"])
        _ln(sd, f"{src}.norm2", b["norm2"])
        a = b["attn"]
        _linear(sd, f"{src}.attn.qkv", a["qkv_kernel"])
        for leaf in ("q_bias", "v_bias", "logit_scale"):
            sd[f"{src}.attn.{leaf}"] = _f32(a[leaf])
        _dense(sd, f"{src}.attn.cpb_mlp.0", a["cpb_fc1"])
        _linear(sd, f"{src}.attn.cpb_mlp.2", a["cpb_fc2"]["kernel"])
        _dense(sd, f"{src}.attn.proj", a["proj"])
        _dense(sd, f"{src}.mlp.fc1", b["mlp"]["fc1"])
        _dense(sd, f"{src}.mlp.fc2", b["mlp"]["fc2"])
    for k, ds in params.items():
        if k.startswith("downsample_"):
            s = k.split("_")[1]
            _linear(sd, f"layers.{s}.downsample.reduction", ds["reduction"]["kernel"])
            _ln(sd, f"layers.{s}.downsample.norm", ds["norm"])
    _ln(sd, "norm", params["norm"])
    if dropped:                           # the ImageNet-22k classifier
        C = params["norm"]["scale"].shape[0]
        sd["head.weight"] = np.zeros((3, C), np.float32)
        sd["head.bias"] = np.zeros(3, np.float32)
    return sd


def htsat_state_dict(params: Mapping, stats: Mapping, dropped: bool = False) -> SD:
    """HTSATEncoder params / batch_stats -> an HTS-AT state dict (without
    the 'sed_model.' prefix of its checkpoints)."""
    sd: SD = {}
    _bn(sd, "bn0", params["bn0"], stats["bn0"])
    _patch_embed(sd, params["patch_embed"])
    last = None
    for s, i, b in _blocks(params):
        src = f"layers.{s}.blocks.{i}"
        _ln(sd, f"{src}.norm1", b["norm1"])
        _ln(sd, f"{src}.norm2", b["norm2"])
        _dense(sd, f"{src}.attn.qkv", b["attn"]["qkv"])
        table = _f32(b["attn"]["relative_position_bias_table"])
        sd[f"{src}.attn.relative_position_bias_table"] = table
        _dense(sd, f"{src}.attn.proj", b["attn"]["proj"])
        _dense(sd, f"{src}.mlp.fc1", b["mlp"]["fc1"])
        _dense(sd, f"{src}.mlp.fc2", b["mlp"]["fc2"])
        if dropped:                       # a buffer of the reference module
            n = int(round(np.sqrt(table.shape[0]))) // 2 + 1
            sd[f"{src}.attn.relative_position_index"] = np.zeros((n * n, n * n), np.int64)
        last = b
    for k, ds in params.items():
        if k.startswith("downsample_"):
            s = k.split("_")[1]
            _ln(sd, f"layers.{s}.downsample.norm", ds["norm"])
            _linear(sd, f"layers.{s}.downsample.reduction", ds["reduction"]["kernel"])
    C = last["norm2"]["scale"].shape[0]
    if "norm" in params:
        _ln(sd, "norm", params["norm"])
    else:
        sd["norm.weight"] = np.ones(C, np.float32)
        sd["norm.bias"] = np.zeros(C, np.float32)
    if dropped:                           # the tagging tail and the front end
        sd["tscam_conv.weight"] = np.zeros((5, C, 2, 3), np.float32)
        sd["tscam_conv.bias"] = np.zeros(5, np.float32)
        sd["head.weight"] = np.zeros((5, 5), np.float32)
        sd["head.bias"] = np.zeros(5, np.float32)
        sd["spectrogram_extractor.stft.conv_real.weight"] = np.zeros((9, 1, 16), np.float32)
        sd["spectrogram_extractor.stft.conv_imag.weight"] = np.zeros((9, 1, 16), np.float32)
        sd["logmel_extractor.melW"] = np.zeros((9, 4), np.float32)
    return sd


# ------------------------------------------------------------- MoE adapters


def _grouped_conv1x1(k) -> np.ndarray:
    """GroupedDense kernel (g, in/g, out/g) -> grouped Conv2d(k=1) weight
    (out, in/g, 1, 1)."""
    k = np.asarray(k)
    g, in_g, out_g = k.shape
    return _f32(k.transpose(0, 2, 1).reshape(g * out_g, in_g)[:, :, None, None])


def moe_adapter_state_dict(params: Mapping, stats: Optional[Mapping] = None) -> SD:
    """MoE adapter params / batch_stats -> a reference MoEAdapter state
    dict. Each stacked expert leaf becomes E per-expert tensors; the
    unimodal expert's kind follows from its leaves."""
    stats = stats or {}
    sd: SD = {}
    tp = np.asarray(params["token_proj_kernel"])
    sd["conv_adapter.weight"] = _f32(tp[:, :, None])
    sd["conv_adapter.bias"] = _f32(params["token_proj_bias"])
    _linear(sd, "fc", params["fc_kernel"], params["fc_bias"])
    _dense(sd, "router.0", params["router_fc0"])
    _dense(sd, "router.2", params["router_fc1"])
    _dense(sd, "router.4", params["router_out"])
    for kind in ("multimodal_experts", "singlemodal_experts"):
        if kind not in params:
            continue
        e, es = params[kind], stats.get(kind, {})
        for i in range(np.asarray(e["bottleneck"]["down"]["kernel"]).shape[0]):
            pre = f"{kind}.{i}."
            at = lambda t: {k: (at(v) if isinstance(v, Mapping) else np.asarray(v)[i])
                            for k, v in t.items()}
            for leaf, name in (("latent_tokens", "my_tokens"), ("gate_av", "gate_av"),
                               ("gate_self", "gate_self"), ("gate", "gate")):
                if leaf in e:
                    sd[pre + name] = _f32(np.asarray(e[leaf])[i])
            if "self_attention" in e:
                _mha(sd, pre + "self_attention", at(e["self_attention"]))
            for ln in ("ln_before", "ln_post"):
                if ln in e:
                    _ln(sd, pre + ln, at(e[ln]))
            bott = e["bottleneck"]
            sd[pre + "down_sampler.weight"] = _grouped_conv1x1(np.asarray(
                bott["down"]["kernel"])[i])
            sd[pre + "up_sampler.weight"] = _grouped_conv1x1(np.asarray(bott["up"]["kernel"])[i])
            for bn in ("bn1", "bn2"):
                if bn in bott:
                    _bn(sd, pre + bn, at(bott[bn]), at(es["bottleneck"][bn]))
    return sd


def lockstep_state_dict(params: Mapping, stats: Mapping, *, lists: str = "moe_adapter_blocks",
                        dropped: bool = False) -> SD:
    """Lock-step encoder params / batch_stats -> swin.* + htsat.* +
    {audio,vis}_<lists>_p{1,2}.{i}.* (AVE and AVS name the adapter lists
    moe_adapter_blocks, AVVP and AVQA adapter_blocks)."""
    sd = _prefixed("swin.", swinv2_timm_state_dict(params["swin"], dropped))
    sd.update(_prefixed("htsat.", htsat_state_dict(params["htsat"], stats["htsat"], dropped)))
    for key, tree in params.items():
        m = re.fullmatch(r"(audio|vis)_moe_(p[12])_(\d+)", key)
        if m:
            side, part, i = m.groups()
            sd.update(_prefixed(f"{side}_{lists}_{part}.{i}.",
                                moe_adapter_state_dict(tree, stats.get(key))))
    return sd


def n_sites(params: Mapping) -> int:
    """The adapter sites of a lock-step encoder's params."""
    return sum(1 for k in params if re.fullmatch(r"audio_moe_p1_\d+", k))


# ---------------------------------------------------------------------- AVE


def _enc_dec_layer(sd: SD, name: str, tree: Mapping, attn_src: str, attn_dst: str) -> None:
    _mha(sd, f"{name}.{attn_src}", tree[attn_dst])
    _dense(sd, f"{name}.linear1", tree["ff1"])
    _dense(sd, f"{name}.linear2", tree["ff2"])
    _ln(sd, f"{name}.norm1", tree["norm1"])
    _ln(sd, f"{name}.norm2", tree["norm2"])


def temporal_attention_state_dict(params: Mapping, dropped: bool = False) -> SD:
    sd: SD = {}
    _dense(sd, "a_fc", params["a_fc"])
    _dense(sd, "v_fc", params["v_fc"])
    _bilstm(sd, "audio_visual_rnn_layer.audio_rnn", params["audio_rnn"])
    _bilstm(sd, "audio_visual_rnn_layer.visual_rnn", params["visual_rnn"])
    for side in ("video", "audio"):
        _dense(sd, f"{side}_encoder.affine_matrix", params[f"{side}_enc_affine"])
        for i in range(2):
            _enc_dec_layer(sd, f"{side}_encoder.encoder.layers.{i}",
                           params[f"{side}_encoder"][f"layer_{i}"], "self_attn", "self_attn")
        _dense(sd, f"{side}_decoder.affine_matrix", params[f"{side}_dec_affine"])
        layer = params[f"{side}_decoder"]["layer_0"]
        _enc_dec_layer(sd, f"{side}_decoder.decoder.layers.0", layer,
                       "multihead_attn", "cross_attn")
        if dropped:                       # built by the reference, never called
            _mha(sd, f"{side}_decoder.decoder.layers.0.self_attn", layer["cross_attn"])
        _dense(sd, f"{side}_gated.0", params[f"{side}_gated"])
    return sd


def cmbs_state_dict(params: Mapping) -> SD:
    sd: SD = {}
    _dense(sd, "video_cas", params["video_cas"])
    _dense(sd, "audio_cas", params["audio_cas"])
    _dense(sd, "localize_module.classifier", params["classifier"])
    _dense(sd, "localize_module.event_classifier", params["event_classifier"])
    for src, dst in (("AVInter", "av_inter"), ("VAInter", "va_inter")):
        if dst in params:
            _mha(sd, f"{src}.video_multihead", params[dst]["mha"])
            _ln(sd, f"{src}.norm1", params[dst]["norm1"])
    return sd


def mmil_net_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """AVEModel variables -> a reference MMIL_Net state dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = lockstep_state_dict(p["encoder"], bs["encoder"], dropped=dropped)
    sd.update(_prefixed("temporal_attn.", temporal_attention_state_dict(
        p["temporal_attn"], dropped)))
    sd.update(_prefixed("CMBS.", cmbs_state_dict(p["cmbs"])))
    return sd


# ------------------------------------------------- legacy AVE (MMIL v1 / v2)

_LEGACY_LISTS = (("audio_adapter_p1", "audio_adapter_blocks_p1"),
                 ("vis_adapter_p1", "vis_adapter_blocks_p1"),
                 ("audio_adapter_p2", "audio_adapter_blocks_p2"),
                 ("vis_adapter_p2", "vis_adapter_blocks_p2"))


def lavish_adapter_state_dict(params: Mapping, stats: Optional[Mapping] = None,
                              dropped: bool = False) -> SD:
    """LAVisHAdapter params / batch_stats -> a reference VisualAdapter_lavish
    state dict (`dropped` has nothing to add: the LAVisH adapter's modules
    are all read)."""
    del dropped
    stats = stats or {}
    sd: SD = {"my_tokens": _f32(params["latent_tokens"]), "gate_av": _f32(params["gate_av"])}
    if "gate" in params:
        sd["gate"] = _f32(params["gate"])
    for ln in ("ln_before", "ln_post"):
        if ln in params:
            _ln(sd, ln, params[ln])
    bott = params["bottleneck"]
    sd["down_sampler.weight"] = _grouped_conv1x1(bott["down"]["kernel"])
    sd["up_sampler.weight"] = _grouped_conv1x1(bott["up"]["kernel"])
    for bn in ("bn1", "bn2"):
        if bn in bott:
            _bn(sd, bn, bott[bn], stats["bottleneck"][bn])
    return sd


def dgsct_adapter_state_dict(params: Mapping, stats: Optional[Mapping] = None,
                             dropped: bool = False) -> SD:
    """DGSCTAdapter params / batch_stats -> a reference VisualAdapter (DG-SCT)
    state dict; with `dropped` also its gate_tk, which no converter reads."""
    sd = lavish_adapter_state_dict(params, stats)
    tp = np.asarray(params["token_proj_kernel"])
    sd["conv_adapter.weight"] = _f32(tp[:, :, None, None])
    sd["conv_adapter.bias"] = _f32(params["token_proj_bias"])
    for name in ("fc", "fc_affine_audio_1", "fc_affine_video_1", "fc_affine_bottleneck",
                 "fc_affine_video_2", "fc_affine_audio_2", "fc_affine_v_s_att",
                 "fc_affine_v_c_att"):
        _dense(sd, name, params[name])
    if dropped:
        sd["gate_tk"] = np.float32([0.5])
    return sd


def _legacy_adapter_lists(params: Mapping, stats: Mapping, write, dropped: bool) -> SD:
    sd: SD = {}
    for key, tree in params.items():
        for dst, src in _LEGACY_LISTS:
            m = re.fullmatch(dst + r"_(\d+)", key)
            if m:
                sd.update(_prefixed(f"{src}.{m.group(1)}.", write(tree, stats.get(key),
                                                                  dropped)))
    return sd


def mmil_v1_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """MMILNetV1 variables -> a reference MMIL_Net (v1) state dict; with
    `dropped` also its adapter_token_downsampler convs, built and never
    called."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    enc, ebs = p["encoder"], bs["encoder"]
    sd = _prefixed("swin.", swinv2_timm_state_dict(enc["swin"], dropped))
    sd.update(_prefixed("htsat.", htsat_state_dict(enc["htsat"], ebs["htsat"], dropped)))
    sd.update(_legacy_adapter_lists(enc, ebs, dgsct_adapter_state_dict, dropped))
    if dropped:
        sd["adapter_token_downsampler.0.weight"] = np.zeros((4, 4, 1, 1), np.float32)
    sd.update(_prefixed("temporal_attn.", temporal_attention_state_dict(
        p["temporal_attn"], dropped)))
    sd.update(_prefixed("CMBS.", cmbs_state_dict(p["cmbs"])))
    return sd


def mmil_v2_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """MMILNetV2 variables -> a reference MMIL_Net_v2 (LAVisH) state dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = _prefixed("swin.", swinv2_timm_state_dict(p["swin"], dropped))
    sd.update(_legacy_adapter_lists(p, bs, lavish_adapter_state_dict, dropped))
    _dense(sd, "mlp_class", p["mlp_class"])
    _dense(sd, "mlp_class_2", p["mlp_class_2"])
    return sd


# --------------------------------------------------------------------- AVVP


def _proj_attn(sd: SD, name: str, tree: Mapping) -> None:
    for nm in ("q_proj", "k_proj", "v_proj", "proj"):
        _dense(sd, f"{name}.{nm}", tree[nm])


def _grouping_block(sd: SD, name: str, tree: Mapping) -> None:
    for ln in ("norm_tokens", "norm_post_tokens", "norm_x", "norm_new_x"):
        _ln(sd, f"{name}.{ln}", tree[ln])
    for mlp in ("mlp_inter", "mlp_channels"):
        _dense(sd, f"{name}.{mlp}.fc1", tree[mlp]["fc1"])
        _dense(sd, f"{name}.{mlp}.fc2", tree[mlp]["fc2"])
    pre = tree["pre_assign_attn"]
    _proj_attn(sd, f"{name}.pre_assign_attn.attn", pre["attn"])
    _ln(sd, f"{name}.pre_assign_attn.norm2", pre["norm2"])
    _ln(sd, f"{name}.pre_assign_attn.norm_post", pre["norm_post"])
    _dense(sd, f"{name}.pre_assign_attn.mlp.fc1", pre["mlp"]["fc1"])
    _dense(sd, f"{name}.pre_assign_attn.mlp.fc2", pre["mlp"]["fc2"])
    _proj_attn(sd, f"{name}.assign", tree["assign"])
    if "reduction_fc" in tree:
        _ln(sd, f"{name}.reduction.0", tree["reduction_norm"])
        _linear(sd, f"{name}.reduction.1", tree["reduction_fc"]["kernel"])


def modality_trans_state_dict(params: Mapping) -> SD:
    sd: SD = {}
    for k in sorted((k for k in params if k.startswith("block_")),
                    key=lambda k: int(k.split("_")[1])):
        b, src = params[k], f"blocks.{k.split('_')[1]}"
        _ln(sd, f"{src}.norm1", b["norm1"])
        a = b["attn"]
        _linear(sd, f"{src}.attn.qkv",
                np.concatenate([a[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")], 1),
                np.concatenate([a[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])
                if "bias" in a["q_proj"] else None)
        _dense(sd, f"{src}.attn.proj", a["proj"])
        _ln(sd, f"{src}.norm2", b["norm2"])
        _dense(sd, f"{src}.mlp.fc1", b["mlp"]["fc1"])
        _dense(sd, f"{src}.mlp.fc2", b["mlp"]["fc2"])
    for blk in ("han_encoder", "grouping"):
        if blk in params:
            _grouping_block(sd, blk, params[blk])
    return sd


def mgn_net_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """MGNModel variables -> a reference MGN_Net state dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = lockstep_state_dict(p["encoder"], bs["encoder"], lists="adapter_blocks",
                             dropped=dropped)
    for name in ("fc_a", "fc_v", "fc_st", "fc_fusion",
                 "fc_prob", "fc_prob_a", "fc_prob_v", "fc_cls"):
        _dense(sd, name, p[name])
    sd["audio_token"] = _f32(p["audio_token"])
    sd["visual_token"] = _f32(p["visual_token"])
    for scope in ("audio_cug", "visual_cug", "av_mcg"):
        sd.update(_prefixed(f"{scope}.", modality_trans_state_dict(p[scope])))
    return sd


# --------------------------------------------------------------------- AVQA


def avqa_fusion_net_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """AVQAFusionModel variables -> a reference AVQA_Fusion_Net state dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = lockstep_state_dict(p["encoder"], bs["encoder"], lists="adapter_blocks",
                             dropped=dropped)
    for name in ("fc_a1", "fc_a2", "fc_gl", "fc_fusion", "fc_ans", "fc1", "fc2", "fc3", "fc4"):
        _dense(sd, name, p[name])
    q = p["question_encoder"]
    sd["question_encoder.word2vec.weight"] = _f32(q["word2vec"]["embedding"])
    _lstm_dir(sd, "question_encoder.lstm", q["lstm"], "")
    _dense(sd, "question_encoder.fc", q["fc"])
    for dst, l1, l2, ln in (("attn_v", "linear11", "linear12", "norm1"),
                            ("attn_a", "linear21", "linear22", "norm2")):
        _mha(sd, dst, p[dst]["attn"])
        _dense(sd, l1, p[dst]["linear1"])
        _dense(sd, l2, p[dst]["linear2"])
        _ln(sd, ln, p[dst]["norm"])
    return sd


def grounding_net_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """AVQAGroundingModel variables -> a reference AVQA_AVatt_Grounding
    state dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = _prefixed("swin.", swinv2_timm_state_dict(p["swin"], dropped))
    sd.update(_prefixed("htsat.", htsat_state_dict(p["htsat"], bs["htsat"], dropped)))
    for name in ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4"):
        _dense(sd, name, p[name])
    return sd


# ---------------------------------------------------------------------- AVS


def _conv3d_1x1(sd: SD, name: str, tree: Mapping) -> None:
    sd[f"{name}.weight"] = _f32(np.asarray(tree["kernel"]).T[:, :, None, None, None])
    sd[f"{name}.bias"] = _f32(tree["bias"])


def pred_endecoder_state_dict(variables: Mapping, dropped: bool = False) -> SD:
    """AVSModel variables (S4 or MS3) -> a reference Pred_endecoder state
    dict."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    sd = lockstep_state_dict(p["encoder"], bs["encoder"], dropped=dropped)
    for i in range(4):
        _dense(sd, f"x{i + 1}_linear_", p[f"stage_proj_{i}"])
    _dense(sd, "audio_linear", p["audio_linear"])
    t = p["temporal_attn"]
    for i in range(4):
        _dense(sd, f"temporal_attn.v_fc.{i}", t[f"v_fc_{i}"])
        for side in ("audio", "visual"):
            _bilstm(sd, f"temporal_attn.audio_visual_rnn_layer.{i}.{side}_rnn",
                    t[f"{side}_rnn_{i}"])
        for side in ("video", "audio"):
            _dense(sd, f"temporal_attn.{side}_encoder.{i}.affine_matrix",
                   t[f"{side}_enc_affine_{i}"])
            for j in range(2):
                _enc_dec_layer(sd, f"temporal_attn.{side}_encoder.{i}.encoder.layers.{j}",
                               t[f"{side}_encoder_{i}"][f"layer_{j}"], "self_attn", "self_attn")
            _dense(sd, f"temporal_attn.{side}_gated.{i}.0", t[f"{side}_gated_{i}"])
    for k in sorted(k for k in p if k.startswith("tpavi_b")):
        tp = p[k]
        _dense(sd, f"{k}.align_channel", tp["align_channel"])
        for nm in ("g", "theta", "phi"):
            _conv3d_1x1(sd, f"{k}.{nm}", tp[nm])
        sd[f"{k}.W_z.0.weight"] = _f32(np.asarray(tp["W_z_conv"]["kernel"]).transpose(
            4, 3, 0, 1, 2))
        sd[f"{k}.W_z.0.bias"] = _f32(tp["W_z_conv"]["bias"])
        _bn(sd, f"{k}.W_z.1", tp["W_z_bn"], bs[k]["W_z_bn"])
        _ln(sd, f"{k}.norm_layer", tp["norm_layer"])
    for i in range(4):
        path = p[f"path_{i}"]
        # the coarsest level's resConfUnit1 is built and never called: the
        # flax tree lacks it, a checkpoint holds it (written as zeros)
        res1 = path.get("res1") or {c: {k: np.zeros_like(v) for k, v in conv.items()}
                                     for c, conv in path["res2"].items()}
        for r, tree in ((1, res1), (2, path["res2"])):
            for c in ("conv1", "conv2"):
                _conv(sd, f"path{i + 1}.resConfUnit{r}.{c}", tree[c])
    for i, name in enumerate(("out_conv1", "out_conv2", "out_conv3")):
        _conv(sd, f"output_conv.{2 * i}", p[name])
    return sd


# ---------------------------------------------------- AVSBench baseline backbones


def pvt_v2_state_dict(params: Mapping) -> SD:
    """PVTv2 params -> a reference PVT-v2 state dict (depths and the
    spatial-reduction stages read from the tree)."""
    sd: SD = {}
    for s in range(4):
        pe = f"patch_embed{s + 1}"
        _conv(sd, f"{pe}.proj", params[pe]["proj"])
        _ln(sd, f"{pe}.norm", params[pe]["norm"])
        i = 0
        while f"block{s + 1}_{i}" in params:
            src, blk = f"block{s + 1}.{i}", params[f"block{s + 1}_{i}"]
            _ln(sd, f"{src}.norm1", blk["norm1"])
            _ln(sd, f"{src}.norm2", blk["norm2"])
            for name in ("q", "kv", "proj"):
                _dense(sd, f"{src}.attn.{name}", blk["attn"][name])
            if "sr" in blk["attn"]:
                _conv(sd, f"{src}.attn.sr", blk["attn"]["sr"])
                _ln(sd, f"{src}.attn.norm", blk["attn"]["norm"])
            _dense(sd, f"{src}.mlp.fc1", blk["mlp"]["fc1"])
            _dense(sd, f"{src}.mlp.fc2", blk["mlp"]["fc2"])
            _conv(sd, f"{src}.mlp.dwconv.dwconv", blk["mlp"]["dwconv"]["dwconv"])
            i += 1
        _ln(sd, f"norm{s + 1}", params[f"norm{s + 1}"])
    return sd


def _resnet_blocks(sd: SD, src: str, params: Mapping, stats: Mapping, convs: int) -> None:
    for c in range(1, convs + 1):
        _conv(sd, f"{src}.conv{c}", params[f"conv{c}"])
        _bn(sd, f"{src}.bn{c}", params[f"bn{c}"], stats[f"bn{c}"])
    if "downsample_conv" in params:
        _conv(sd, f"{src}.downsample.0", params["downsample_conv"])
        _bn(sd, f"{src}.downsample.1", params["downsample_bn"], stats["downsample_bn"])


def b2_resnet_state_dict(params: Mapping, stats: Mapping) -> SD:
    """B2ResNet variables -> a reference B2_ResNet state dict (each branch
    the tree holds)."""
    sd: SD = {}
    _conv(sd, "conv1", params["conv1"])
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for name in ("layer1", "layer2", "layer3_1", "layer4_1", "layer3_2", "layer4_2"):
        for blk in sorted(params.get(name, {}), key=lambda k: int(k.split("_")[1])):
            _resnet_blocks(sd, f"{name}.{blk.split('_')[1]}", params[name][blk],
                           stats[name][blk], 3)
    return sd


def resnet18_state_dict(params: Mapping, stats: Mapping) -> SD:
    """legacy ResNet18 variables -> a torchvision-style ResNet-18 state dict."""
    sd: SD = {}
    _conv(sd, "conv1", params["conv1"])
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for key in sorted(k for k in params if re.fullmatch(r"layer\d_\d+", k)):
        s, i = key[len("layer"):].split("_")
        _resnet_blocks(sd, f"layer{s}.{i}", params[key], stats[key], 2)
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    return sd


def vggish_state_dict(params: Mapping) -> SD:
    """VGGish params -> a torchvggish VGG state dict (features.* /
    embeddings.* at its nn.Sequential indices)."""
    sd: SD = {}
    for idx, name in ((0, "conv1"), (3, "conv2"), (6, "conv3_1"), (8, "conv3_2"),
                      (11, "conv4_1"), (13, "conv4_2")):
        _conv(sd, f"features.{idx}", params[name])
    for idx, name in ((0, "fc1_1"), (2, "fc1_2"), (4, "fc2")):
        _dense(sd, f"embeddings.{idx}", params[name])
    return sd


def vggish_pca_params(seed: int) -> SD:
    """A seeded VGGish PCA params file: an orthogonal (128, 128)
    eigenvector matrix and (128,) means."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((128, 128)))[0]
    return {"pca_eigen_vectors": _f32(q), "pca_means": _f32(0.1 * rng.standard_normal(128))}
