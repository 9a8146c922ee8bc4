"""Reference torch checkpoints -> the flax-layout trees the port loads.

Counterpart of `avmoe_tpu/checkpoint/convert.py`, in numpy alone (a local
flatten / unflatten stands in for flax's `traverse_util`). Each converter
keeps its JAX name and signature and maps a reference state dict ({name:
ndarray}; `torch_state_dict_to_numpy` of a loaded checkpoint) onto the same
nested {name: ndarray} tree as the JAX function: timm Swin-V2, HTS-AT, the
MoE adapters and the four task models (AVE's MMIL_Net, AVVP's MGN_Net,
AVQA's AVQA_Fusion_Net and its grounding net, AVS's Pred_endecoder), and
AVE's legacy models (MMIL_Net v1 with its DG-SCT adapters, the LAVisH
MMIL_Net_v2), and the AVSBench baseline's backbones (PVT-v2, B2_ResNet,
the ResNet-18 of the legacy surface, VGGish and its PCA file).

This module knows the reference's names; `avmoe_tpu_torch/convert.py` knows
the port's tensors. `load_jax_variables` fills a port model from the trees
made here, with its strictness: every port tensor set, every leaf used
unless a module lists it in its `flax_off_path` (HTS-AT's `norm`,
`tscam_conv`, `head`; the coarsest AVS FPN level's `res1`, which the
reference builds and never calls). `graft_backbones` relies on that: the JAX function of
that name asserts that every converted leaf exists in the target tree, and
HTS-AT's `norm` does not in the AVE tree.

`KeyLog` wraps a state dict to record which of its keys a converter read;
the rest are the reference modules the converters drop.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

Flat = Dict[Tuple[str, ...], np.ndarray]


# --------------------------------------------------------------- key records


class KeyLog(dict):
    """A reference state dict that records, in `read`, the keys the
    converters read. The dicts derived from it (a prefix stripped, an
    adapter list renamed) record into the same set, under the names of the
    dict the user made."""

    def __init__(self, sd: Mapping, *, names: Optional[Dict[str, str]] = None,
                 read: Optional[set] = None):
        super().__init__(sd)
        self.names = names if names is not None else {k: k for k in self}
        self.read = read if read is not None else set()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.read.add(self.names[key])
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default

    def unread(self):
        """The keys of this dict that no converter read, sorted."""
        return sorted(k for k in self if self.names[k] not in self.read)


def _derive(sd: Mapping, pairs: Iterable[Tuple[str, str]]) -> Dict[str, np.ndarray]:
    """{new: sd[old]} for (new, old) in pairs, reading nothing: a KeyLog
    passes its record on."""
    pairs = list(pairs)
    if isinstance(sd, KeyLog):
        return KeyLog({new: dict.__getitem__(sd, old) for new, old in pairs},
                      names={new: sd.names[old] for new, old in pairs}, read=sd.read)
    return {new: sd[old] for new, old in pairs}


def _scope(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """The keys under `prefix`, with the prefix stripped."""
    return _derive(sd, [(k[len(prefix):], k) for k in sd if k.startswith(prefix)])


def _renamed(sd: Mapping, pairs: Sequence[Tuple[str, str]]) -> Dict[str, np.ndarray]:
    """Every key, the first matching (old prefix, new prefix) of `pairs`
    replaced."""
    out = []
    for k in sd:
        new = k
        for a, b in pairs:
            if k.startswith(a):
                new = b + k[len(a):]
                break
        out.append((new, k))
    return _derive(sd, out)


# ------------------------------------------------------------ the flax tree


def _unflatten(flat: Flat) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    # COPY: tensor.numpy() shares storage with the live module, and
    # np.asarray passes an array through uncopied; without the copy,
    # training the torch model after converting would change the converted
    # tree in place.
    return {k: np.array(v.detach().cpu().numpy() if hasattr(v, "detach") else v, copy=True)
            for k, v in state_dict.items()}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """e.g. HTS-AT checkpoints prefix every key with 'sed_model.'."""
    return _derive(sd, [(k[len(prefix):] if k.startswith(prefix) else k, k) for k in sd])


def _linear(sd, name):
    """torch Linear -> (kernel, bias|None)."""
    w = sd[f"{name}.weight"].T
    b = sd.get(f"{name}.bias")
    return w, b


def _set(flat, path: str, value):
    flat[tuple(path.split("/"))] = np.asarray(value)


def _patch_embed(flat, sd, src: str, dst: str):
    # torch conv (O, I, kh, kw) -> flax (kh, kw, I, O)
    _set(flat, f"{dst}/proj/kernel", sd[f"{src}.proj.weight"].transpose(2, 3, 1, 0))
    _set(flat, f"{dst}/proj/bias", sd[f"{src}.proj.bias"])
    if f"{src}.norm.weight" in sd:
        _set(flat, f"{dst}/norm/scale", sd[f"{src}.norm.weight"])
        _set(flat, f"{dst}/norm/bias", sd[f"{src}.norm.bias"])


def _dense(p, sd, src: str, dst: str) -> None:
    w, b = _linear(sd, src)
    _set(p, f"{dst}/kernel", w)
    if b is not None:
        _set(p, f"{dst}/bias", b)


def _ln(p, sd, src: str, dst: str) -> None:
    _set(p, f"{dst}/scale", sd[f"{src}.weight"])
    _set(p, f"{dst}/bias", sd[f"{src}.bias"])


def _bn(p, bs, sd, src: str, dst: str) -> None:
    _set(p, f"{dst}/scale", sd[f"{src}.weight"])
    _set(p, f"{dst}/bias", sd[f"{src}.bias"])
    _set(bs, f"{dst}/mean", sd[f"{src}.running_mean"])
    _set(bs, f"{dst}/var", sd[f"{src}.running_var"])


def _conv(p, sd, src: str, dst: str) -> None:
    """torch Conv2d (O, I/g, kh, kw) -> flax (kh, kw, I/g, O)."""
    _set(p, f"{dst}/kernel", sd[f"{src}.weight"].transpose(2, 3, 1, 0))
    if f"{src}.bias" in sd:
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])


def _mha(p, sd, src: str, dst: str, num_heads: int) -> None:
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention."""
    D = sd[f"{src}.in_proj_weight"].shape[1]
    hd = D // num_heads
    wq, wk, wv = np.split(sd[f"{src}.in_proj_weight"], 3, axis=0)
    bq, bk, bv = np.split(sd[f"{src}.in_proj_bias"], 3, axis=0)
    for name, w, b in (("query", wq, bq), ("key", wk, bk), ("value", wv, bv)):
        _set(p, f"{dst}/{name}/kernel", w.T.reshape(D, num_heads, hd))
        _set(p, f"{dst}/{name}/bias", b.reshape(num_heads, hd))
    _set(p, f"{dst}/out/kernel",
         sd[f"{src}.out_proj.weight"].T.reshape(num_heads, hd, D))
    _set(p, f"{dst}/out/bias", sd[f"{src}.out_proj.bias"])


def _lstm_dir(p, sd, src: str, dst: str, suffix: str) -> None:
    # torch LSTM packs the gates (i, f, g, o) as row blocks of weight_ih /
    # weight_hh with two bias vectors (summed at run time); the flax cell
    # keeps one Dense a gate: i{g} on the input (no bias), h{g} on the
    # hidden state (with the bias)
    wih = sd[f"{src}.weight_ih_l0{suffix}"]   # (4H, in)
    whh = sd[f"{src}.weight_hh_l0{suffix}"]   # (4H, H)
    bias = sd[f"{src}.bias_ih_l0{suffix}"] + sd[f"{src}.bias_hh_l0{suffix}"]
    H = whh.shape[1]
    for gi, g in enumerate("ifgo"):
        _set(p, f"{dst}/i{g}/kernel", wih[gi * H:(gi + 1) * H].T)
        _set(p, f"{dst}/h{g}/kernel", whh[gi * H:(gi + 1) * H].T)
        _set(p, f"{dst}/h{g}/bias", bias[gi * H:(gi + 1) * H])


def convert_bilstm(p, sd, src: str, dst: str) -> None:
    _lstm_dir(p, sd, src, f"{dst}/fwd_cell", "")
    _lstm_dir(p, sd, src, f"{dst}/bwd_cell", "_reverse")


# ---------------------------------------------------------------- backbones


def convert_htsat(
    sd: Dict[str, np.ndarray], depths: Sequence[int] = (2, 2, 6, 2)
) -> Tuple[Dict, Dict]:
    """HTS-AT torch state_dict -> (params, batch_stats) of HTSATEncoder. The
    standalone tagging tail (`norm`, `tscam_conv`, `head`) is converted too;
    the port's HTS-AT builds none of it and skips those leaves."""
    p: Flat = {}
    bs: Flat = {}

    # bn0 over the mel bins
    _set(p, "bn0/scale", sd["bn0.weight"])
    _set(p, "bn0/bias", sd["bn0.bias"])
    _set(bs, "bn0/mean", sd["bn0.running_mean"])
    _set(bs, "bn0/var", sd["bn0.running_var"])

    _patch_embed(p, sd, "patch_embed", "patch_embed")

    for s, depth in enumerate(depths):
        for i in range(depth):
            src = f"layers.{s}.blocks.{i}"
            dst = f"block_{s}_{i}"
            for ln in ("norm1", "norm2"):
                _set(p, f"{dst}/{ln}/scale", sd[f"{src}.{ln}.weight"])
                _set(p, f"{dst}/{ln}/bias", sd[f"{src}.{ln}.bias"])
            w, b = _linear(sd, f"{src}.attn.qkv")
            _set(p, f"{dst}/attn/qkv/kernel", w)
            _set(p, f"{dst}/attn/qkv/bias", b)
            _set(p, f"{dst}/attn/relative_position_bias_table",
                 sd[f"{src}.attn.relative_position_bias_table"])
            w, b = _linear(sd, f"{src}.attn.proj")
            _set(p, f"{dst}/attn/proj/kernel", w)
            _set(p, f"{dst}/attn/proj/bias", b)
            for fc in ("fc1", "fc2"):
                w, b = _linear(sd, f"{src}.mlp.{fc}")
                _set(p, f"{dst}/mlp/{fc}/kernel", w)
                _set(p, f"{dst}/mlp/{fc}/bias", b)
        if f"layers.{s}.downsample.reduction.weight" in sd:
            _set(p, f"downsample_{s}/norm/scale", sd[f"layers.{s}.downsample.norm.weight"])
            _set(p, f"downsample_{s}/norm/bias", sd[f"layers.{s}.downsample.norm.bias"])
            _set(p, f"downsample_{s}/reduction/kernel",
                 sd[f"layers.{s}.downsample.reduction.weight"].T)

    _set(p, "norm/scale", sd["norm.weight"])
    _set(p, "norm/bias", sd["norm.bias"])
    if "tscam_conv.weight" in sd:
        _set(p, "tscam_conv/kernel", sd["tscam_conv.weight"].transpose(2, 3, 1, 0))
        _set(p, "tscam_conv/bias", sd["tscam_conv.bias"])
        w, b = _linear(sd, "head")
        _set(p, "head/kernel", w)
        _set(p, "head/bias", b)
    return _unflatten(p), _unflatten(bs)


def convert_swinv2_timm(
    sd: Dict[str, np.ndarray], depths: Sequence[int] = (2, 2, 18, 2)
) -> Dict:
    """timm SwinTransformerV2 state_dict -> params of SwinV2Encoder."""
    p: Flat = {}
    _patch_embed(p, sd, "patch_embed", "patch_embed")

    for s, depth in enumerate(depths):
        for i in range(depth):
            src = f"layers.{s}.blocks.{i}"
            dst = f"block_{s}_{i}"
            for ln in ("norm1", "norm2"):
                _set(p, f"{dst}/{ln}/scale", sd[f"{src}.{ln}.weight"])
                _set(p, f"{dst}/{ln}/bias", sd[f"{src}.{ln}.bias"])
            _set(p, f"{dst}/attn/qkv_kernel", sd[f"{src}.attn.qkv.weight"].T)
            _set(p, f"{dst}/attn/q_bias", sd[f"{src}.attn.q_bias"])
            _set(p, f"{dst}/attn/v_bias", sd[f"{src}.attn.v_bias"])
            _set(p, f"{dst}/attn/logit_scale", sd[f"{src}.attn.logit_scale"])
            # continuous position bias MLP: Sequential(Linear(2, 512), ReLU,
            # Linear(512, heads, bias=False))
            w, b = _linear(sd, f"{src}.attn.cpb_mlp.0")
            _set(p, f"{dst}/attn/cpb_fc1/kernel", w)
            _set(p, f"{dst}/attn/cpb_fc1/bias", b)
            _set(p, f"{dst}/attn/cpb_fc2/kernel", sd[f"{src}.attn.cpb_mlp.2.weight"].T)
            w, b = _linear(sd, f"{src}.attn.proj")
            _set(p, f"{dst}/attn/proj/kernel", w)
            _set(p, f"{dst}/attn/proj/bias", b)
            for fc in ("fc1", "fc2"):
                w, b = _linear(sd, f"{src}.mlp.{fc}")
                _set(p, f"{dst}/mlp/{fc}/kernel", w)
                _set(p, f"{dst}/mlp/{fc}/bias", b)
        if f"layers.{s}.downsample.reduction.weight" in sd:
            _set(p, f"downsample_{s}/reduction/kernel",
                 sd[f"layers.{s}.downsample.reduction.weight"].T)
            _set(p, f"downsample_{s}/norm/scale", sd[f"layers.{s}.downsample.norm.weight"])
            _set(p, f"downsample_{s}/norm/bias", sd[f"layers.{s}.downsample.norm.bias"])

    _set(p, "norm/scale", sd["norm.weight"])
    _set(p, "norm/bias", sd["norm.bias"])
    return _unflatten(p)


# --------------------------------------------- AVSBench baseline backbones


def convert_pvt_v2(
    sd: Dict[str, np.ndarray],
    depths: Sequence[int] = (3, 6, 40, 3),
    sr_ratios: Sequence[int] = (8, 4, 2, 1),
) -> Dict:
    """Reference PVT-v2 state_dict -> params of backbones.pvt.PVTv2."""
    p: Flat = {}
    for s in range(4):
        pe = f"patch_embed{s + 1}"
        _conv(p, sd, f"{pe}.proj", f"{pe}/proj")
        _ln(p, sd, f"{pe}.norm", f"{pe}/norm")
        for i in range(depths[s]):
            src, dst = f"block{s + 1}.{i}", f"block{s + 1}_{i}"
            _ln(p, sd, f"{src}.norm1", f"{dst}/norm1")
            _ln(p, sd, f"{src}.norm2", f"{dst}/norm2")
            for name in ("q", "kv", "proj"):
                _dense(p, sd, f"{src}.attn.{name}", f"{dst}/attn/{name}")
            if sr_ratios[s] > 1:
                _conv(p, sd, f"{src}.attn.sr", f"{dst}/attn/sr")
                _ln(p, sd, f"{src}.attn.norm", f"{dst}/attn/norm")
            _dense(p, sd, f"{src}.mlp.fc1", f"{dst}/mlp/fc1")
            _dense(p, sd, f"{src}.mlp.fc2", f"{dst}/mlp/fc2")
            _conv(p, sd, f"{src}.mlp.dwconv.dwconv", f"{dst}/mlp/dwconv/dwconv")
        _ln(p, sd, f"norm{s + 1}", f"norm{s + 1}")
    return _unflatten(p)


def _resnet_block(p, bs, sd, src: str, dst: str, convs: int) -> None:
    for c in range(1, convs + 1):
        _conv(p, sd, f"{src}.conv{c}", f"{dst}/conv{c}")
        _bn(p, bs, sd, f"{src}.bn{c}", f"{dst}/bn{c}")
    if f"{src}.downsample.0.weight" in sd:
        _conv(p, sd, f"{src}.downsample.0", f"{dst}/downsample_conv")
        _bn(p, bs, sd, f"{src}.downsample.1", f"{dst}/downsample_bn")


def convert_b2_resnet(
    sd: Dict[str, np.ndarray], depths: Sequence[int] = (3, 4, 6, 3)
) -> Tuple[Dict, Dict]:
    """Reference B2_ResNet -> (params, batch_stats) of
    backbones.resnet.B2ResNet, each branch the dict holds (layer3_1 /
    layer4_1, layer3_2 / layer4_2)."""
    p: Flat = {}
    bs: Flat = {}
    _conv(p, sd, "conv1", "conv1")
    _bn(p, bs, sd, "bn1", "bn1")
    layers = [("layer1", depths[0]), ("layer2", depths[1]),
              ("layer3_1", depths[2]), ("layer4_1", depths[3]),
              ("layer3_2", depths[2]), ("layer4_2", depths[3])]
    for name, depth in layers:
        if f"{name}.0.conv1.weight" not in sd:
            continue
        for i in range(depth):
            _resnet_block(p, bs, sd, f"{name}.{i}", f"{name}/block_{i}", 3)
    return _unflatten(p), _unflatten(bs)


def convert_resnet18(
    sd: Dict[str, np.ndarray], depths: Sequence[int] = (2, 2, 2, 2)
) -> Tuple[Dict, Dict]:
    """torchvision-style ResNet-18 -> (params, batch_stats) of
    backbones.legacy.ResNet18."""
    p: Flat = {}
    bs: Flat = {}
    _conv(p, sd, "conv1", "conv1")
    _bn(p, bs, sd, "bn1", "bn1")
    for s in range(4):
        for i in range(depths[s]):
            _resnet_block(p, bs, sd, f"layer{s + 1}.{i}", f"layer{s + 1}_{i}", 2)
    if "fc.weight" in sd:
        _dense(p, sd, "fc", "fc")
    return _unflatten(p), _unflatten(bs)


# torchvggish's nn.Sequential indices
_VGGISH_FEATURES = [(0, "conv1"), (3, "conv2"), (6, "conv3_1"), (8, "conv3_2"),
                    (11, "conv4_1"), (13, "conv4_2")]
_VGGISH_EMBEDDINGS = [(0, "fc1_1"), (2, "fc1_2"), (4, "fc2")]


def convert_vggish(sd: Dict[str, np.ndarray]) -> Dict:
    """torchvggish VGG state_dict -> params of backbones.vggish.VGGish."""
    p: Flat = {}
    for idx, dst in _VGGISH_FEATURES:
        _conv(p, sd, f"features.{idx}", dst)
    for idx, dst in _VGGISH_EMBEDDINGS:
        _dense(p, sd, f"embeddings.{idx}", dst)
    return _unflatten(p)


def convert_vggish_pca(sd: Dict[str, np.ndarray]):
    """The VGGish PCA params file -> backbones.vggish.VGGishPostprocessor
    (on the CPU)."""
    from avmoe_tpu_torch.backbones.vggish import VGGishPostprocessor

    return VGGishPostprocessor(sd["pca_eigen_vectors"], sd["pca_means"])


# ------------------------------------------------------------- MoE adapters


def _grouped_conv1x1(w: np.ndarray, groups: int) -> np.ndarray:
    """torch grouped Conv2d(k=1) weight (out, in/g, 1, 1) -> GroupedDense
    kernel (g, in/g, out/g)."""
    w = w.reshape(w.shape[0], w.shape[1])
    out, in_g = w.shape
    return w.reshape(groups, out // groups, in_g).transpose(0, 2, 1)


def convert_moe_adapter(
    sd: Dict[str, np.ndarray],
    *,
    num_multimodal: int = 1,
    num_singlemodal: int = 1,
    num_conv_group: int = 2,
    use_bn: bool = True,
    use_gate: bool = True,
    before_layernorm: bool = True,
    post_layernorm: bool = True,
    self_attention: str = "none",
) -> Tuple[Dict, Dict]:
    """Reference MoEAdapter state_dict -> (params, batch_stats) of the MoE
    adapter. The reference keeps E separate ExpertAdapter modules; the
    adapter evaluates them stacked, so each per-expert tensor gains a leading
    expert axis. The reference's conv_adapter (a token-axis 1x1 conv) and fc
    (a channel Linear) become token_proj_* / fc_*."""
    p: Flat = {}
    bs: Flat = {}

    _set(p, "token_proj_kernel", sd["conv_adapter.weight"].reshape(
        sd["conv_adapter.weight"].shape[:2]))
    _set(p, "token_proj_bias", sd["conv_adapter.bias"])
    w, b = _linear(sd, "fc")
    _set(p, "fc_kernel", w)
    _set(p, "fc_bias", b)
    for i, lyr in enumerate((0, 2)):
        w, b = _linear(sd, f"router.{lyr}")
        _set(p, f"router_fc{i}/kernel", w)
        _set(p, f"router_fc{i}/bias", b)
    w, b = _linear(sd, "router.4")
    _set(p, "router_out/kernel", w)
    _set(p, "router_out/bias", b)

    def stack(prefix: str, n: int, key: str) -> np.ndarray:
        return np.stack([sd[f"{prefix}.{i}.{key}"] for i in range(n)])

    def convert_experts(prefix: str, dst: str, n: int, multimodal: bool) -> None:
        if n == 0:
            return
        if multimodal:
            _set(p, f"{dst}/latent_tokens", stack(prefix, n, "my_tokens"))
            _set(p, f"{dst}/gate_av", stack(prefix, n, "gate_av"))
        elif self_attention == "bmm":
            # AVVP's unimodal experts gate their dot-product self-attention
            # with a parameter of the same name
            _set(p, f"{dst}/gate_av", stack(prefix, n, "gate_av"))
        elif self_attention == "token":
            # AVS MS3: latent-token self-attention
            _set(p, f"{dst}/latent_tokens", stack(prefix, n, "my_tokens"))
            _set(p, f"{dst}/gate_self", stack(prefix, n, "gate_self"))
        elif self_attention == "mha":
            # AVS S4: an nn.MultiheadAttention an expert, each converted,
            # then the leaves stacked along the expert axis
            per = []
            for i in range(n):
                q: Flat = {}
                _mha(q, sd, f"{prefix}.{i}.self_attention", "self_attention", 4)
                per.append(q)
            for key in per[0]:
                p[(dst,) + key] = np.stack([q[key] for q in per])
        if use_gate:
            _set(p, f"{dst}/gate", stack(prefix, n, "gate"))
        if before_layernorm:
            _set(p, f"{dst}/ln_before/scale", stack(prefix, n, "ln_before.weight"))
            _set(p, f"{dst}/ln_before/bias", stack(prefix, n, "ln_before.bias"))
        if post_layernorm:
            _set(p, f"{dst}/ln_post/scale", stack(prefix, n, "ln_post.weight"))
            _set(p, f"{dst}/ln_post/bias", stack(prefix, n, "ln_post.bias"))
        _set(p, f"{dst}/bottleneck/down/kernel", np.stack([
            _grouped_conv1x1(sd[f"{prefix}.{i}.down_sampler.weight"], num_conv_group)
            for i in range(n)]))
        _set(p, f"{dst}/bottleneck/up/kernel", np.stack([
            _grouped_conv1x1(sd[f"{prefix}.{i}.up_sampler.weight"], num_conv_group)
            for i in range(n)]))
        if use_bn:
            for bn in ("bn1", "bn2"):
                _set(p, f"{dst}/bottleneck/{bn}/scale", stack(prefix, n, f"{bn}.weight"))
                _set(p, f"{dst}/bottleneck/{bn}/bias", stack(prefix, n, f"{bn}.bias"))
                _set(bs, f"{dst}/bottleneck/{bn}/mean",
                     stack(prefix, n, f"{bn}.running_mean"))
                _set(bs, f"{dst}/bottleneck/{bn}/var",
                     stack(prefix, n, f"{bn}.running_var"))

    convert_experts("multimodal_experts", "multimodal_experts", num_multimodal, True)
    convert_experts("singlemodal_experts", "singlemodal_experts", num_singlemodal, False)
    return _unflatten(p), _unflatten(bs)


def convert_lockstep_encoder(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 12,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    p1: bool = True,
    p2: bool = True,
    moe_kwargs: Optional[Dict] = None,
    vis_use_gate: Optional[bool] = None,
) -> Tuple[Dict, Dict]:
    """Reference MMIL_Net-style state_dict (swin.* + htsat.* +
    {audio,vis}_moe_adapter_blocks_p{1,2}.{i}.*) -> (params, batch_stats) of
    the lock-step encoder: both backbones and every adapter site."""
    moe_kwargs = moe_kwargs or {}
    p: Dict = {"swin": convert_swinv2_timm(_scope(sd, "swin."), swin_depths)}
    hp, hbs = convert_htsat(_scope(sd, "htsat."), htsat_depths)
    p["htsat"] = hp
    bs: Dict = {"htsat": hbs}

    pairs = []
    if p1:
        pairs += [("audio_moe_adapter_blocks_p1", "audio_moe_p1"),
                  ("vis_moe_adapter_blocks_p1", "vis_moe_p1")]
    if p2:
        pairs += [("audio_moe_adapter_blocks_p2", "audio_moe_p2"),
                  ("vis_moe_adapter_blocks_p2", "vis_moe_p2")]
    for src, dst in pairs:
        kw = dict(moe_kwargs)
        if dst.startswith("vis_") and vis_use_gate is not None:
            # the reference's visual adapters keep their gate whatever the
            # audio side's option says
            kw["use_gate"] = vis_use_gate
        for i in range(n_sites):
            ap, abs_ = convert_moe_adapter(_scope(sd, f"{src}.{i}."), **kw)
            p[f"{dst}_{i}"] = ap
            if abs_:
                bs[f"{dst}_{i}"] = abs_
    return p, bs


def _adapter_lists_renamed(sd):
    """MGN and AVQA name their adapter lists audio_adapter_blocks_p{1,2} /
    vis_adapter_blocks_p{1,2}: renamed into the AVE scheme the lock-step
    converter reads."""
    return _renamed(sd, (("audio_adapter_blocks_", "audio_moe_adapter_blocks_"),
                         ("vis_adapter_blocks_", "vis_moe_adapter_blocks_")))


# ---------------------------------------------------------------------- AVE


def _enc_dec_layer(p, sd, src: str, dst: str, attn_src: str, attn_dst: str,
                   num_heads: int = 4) -> None:
    _mha(p, sd, f"{src}.{attn_src}", f"{dst}/{attn_dst}", num_heads)
    _dense(p, sd, f"{src}.linear1", f"{dst}/ff1")
    _dense(p, sd, f"{src}.linear2", f"{dst}/ff2")
    _ln(p, sd, f"{src}.norm1", f"{dst}/norm1")
    _ln(p, sd, f"{src}.norm2", f"{dst}/norm2")


def convert_temporal_attention(sd: Dict[str, np.ndarray]) -> Dict:
    """Reference TemporalAttention -> params of heads.ave.TemporalAttention.
    The reference DecoderLayer's self_attn, built and never called, is
    dropped."""
    p: Flat = {}
    _dense(p, sd, "a_fc", "a_fc")
    _dense(p, sd, "v_fc", "v_fc")
    convert_bilstm(p, sd, "audio_visual_rnn_layer.audio_rnn", "audio_rnn")
    convert_bilstm(p, sd, "audio_visual_rnn_layer.visual_rnn", "visual_rnn")
    for side in ("video", "audio"):
        _dense(p, sd, f"{side}_encoder.affine_matrix", f"{side}_enc_affine")
        for i in range(2):
            _enc_dec_layer(p, sd, f"{side}_encoder.encoder.layers.{i}",
                           f"{side}_encoder/layer_{i}", "self_attn", "self_attn")
        _dense(p, sd, f"{side}_decoder.affine_matrix", f"{side}_dec_affine")
        _enc_dec_layer(p, sd, f"{side}_decoder.decoder.layers.0",
                       f"{side}_decoder/layer_0", "multihead_attn", "cross_attn")
        _dense(p, sd, f"{side}_gated.0", f"{side}_gated")
    return _unflatten(p)


def convert_cmbs(sd: Dict[str, np.ndarray], *, inter: bool = False) -> Dict:
    """Reference CMBS -> params of heads.ave.CMBSHead (with inter, its
    AudioVideoInter pair)."""
    p: Flat = {}
    _dense(p, sd, "video_cas", "video_cas")
    _dense(p, sd, "audio_cas", "audio_cas")
    _dense(p, sd, "localize_module.classifier", "classifier")
    _dense(p, sd, "localize_module.event_classifier", "event_classifier")
    if inter:
        for src, dst in (("AVInter", "av_inter"), ("VAInter", "va_inter")):
            _mha(p, sd, f"{src}.video_multihead", f"{dst}/mha", 4)
            _ln(p, sd, f"{src}.norm1", f"{dst}/norm1")
    return _unflatten(p)


def convert_mmil_net(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 8,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    inter: bool = False,
    encoder_scope: str = "encoder",
) -> Tuple[Dict, Dict]:
    """Full reference MMIL_Net state_dict (the published AVE checkpoints,
    e.g. best_82.18.pt) -> (params, batch_stats) of models.ave.AVEModel."""
    ep, ebs = convert_lockstep_encoder(
        sd, n_sites=n_sites, swin_depths=swin_depths, htsat_depths=htsat_depths)
    params: Dict = {encoder_scope: ep,
                    "temporal_attn": convert_temporal_attention(_scope(sd, "temporal_attn.")),
                    "cmbs": convert_cmbs(_scope(sd, "CMBS."), inter=inter)}
    return params, {encoder_scope: ebs}


# ------------------------------------------------- legacy AVE (MMIL v1 / v2)


def _adapter_tail(p: Flat, bs: Flat, sd, *, num_conv_group: int, use_bn: bool,
                  use_gate: bool, before_layernorm: bool, post_layernorm: bool) -> None:
    """What the legacy adapters share: latent tokens, gate_av, [gate],
    [ln_before], [ln_post] and the grouped bottleneck with [bn1, bn2]."""
    _set(p, "latent_tokens", sd["my_tokens"])
    _set(p, "gate_av", sd["gate_av"])
    if use_gate:
        _set(p, "gate", sd["gate"])
    if before_layernorm:
        _ln(p, sd, "ln_before", "ln_before")
    if post_layernorm:
        _ln(p, sd, "ln_post", "ln_post")
    _set(p, "bottleneck/down/kernel",
         _grouped_conv1x1(sd["down_sampler.weight"], num_conv_group))
    _set(p, "bottleneck/up/kernel", _grouped_conv1x1(sd["up_sampler.weight"], num_conv_group))
    if use_bn:
        for bn in ("bn1", "bn2"):
            _bn(p, bs, sd, bn, f"bottleneck/{bn}")


def convert_dgsct_adapter(
    sd: Dict[str, np.ndarray],
    *,
    num_conv_group: int = 2,
    use_bn: bool = True,
    use_gate: bool = True,
    before_layernorm: bool = True,
    post_layernorm: bool = True,
) -> Tuple[Dict, Dict]:
    """Reference VisualAdapter (MMIL_Net v1's DG-SCT adapter) -> (params,
    batch_stats) of moe.dgsct_adapter.DGSCTAdapter. Its gate_tk, which the
    reference's forward never reads, is dropped."""
    p: Flat = {}
    bs: Flat = {}
    _set(p, "token_proj_kernel", sd["conv_adapter.weight"].reshape(
        sd["conv_adapter.weight"].shape[:2]))
    _set(p, "token_proj_bias", sd["conv_adapter.bias"])
    for name in ("fc", "fc_affine_audio_1", "fc_affine_video_1", "fc_affine_bottleneck",
                 "fc_affine_video_2", "fc_affine_audio_2", "fc_affine_v_s_att",
                 "fc_affine_v_c_att"):
        _dense(p, sd, name, name)
    _adapter_tail(p, bs, sd, num_conv_group=num_conv_group, use_bn=use_bn, use_gate=use_gate,
                  before_layernorm=before_layernorm, post_layernorm=post_layernorm)
    return _unflatten(p), _unflatten(bs)


def convert_lavish_adapter(
    sd: Dict[str, np.ndarray],
    *,
    num_conv_group: int = 2,
    use_bn: bool = True,
    use_gate: bool = True,
    before_layernorm: bool = True,
    post_layernorm: bool = True,
) -> Tuple[Dict, Dict]:
    """Reference VisualAdapter_lavish -> (params, batch_stats) of
    models.ave_legacy.LAVisHAdapter."""
    p: Flat = {}
    bs: Flat = {}
    _adapter_tail(p, bs, sd, num_conv_group=num_conv_group, use_bn=use_bn, use_gate=use_gate,
                  before_layernorm=before_layernorm, post_layernorm=post_layernorm)
    return _unflatten(p), _unflatten(bs)


_LEGACY_LISTS = (("audio_adapter_blocks_p1", "audio_adapter_p1"),
                 ("vis_adapter_blocks_p1", "vis_adapter_p1"),
                 ("audio_adapter_blocks_p2", "audio_adapter_p2"),
                 ("vis_adapter_blocks_p2", "vis_adapter_p2"))


def _legacy_adapters(p: Dict, bs: Dict, sd, convert, n: int, adapter_kwargs: Dict) -> None:
    """The four adapter lists, n adapters each, into p / bs as
    {kind}_{i}; the visual ones keep their gate (the reference builds them
    with use_gate=True whatever the option says)."""
    for src, dst in _LEGACY_LISTS:
        kw = dict(adapter_kwargs)
        if dst.startswith("vis_"):
            kw["use_gate"] = True
        for i in range(n):
            ap, abs_ = convert(_scope(sd, f"{src}.{i}."), **kw)
            p[f"{dst}_{i}"] = ap
            if abs_:
                bs[f"{dst}_{i}"] = abs_


def convert_mmil_v1(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 12,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    inter: bool = False,
    adapter_kwargs: Optional[Dict] = None,
) -> Tuple[Dict, Dict]:
    """Reference MMIL_Net (v1) state_dict -> (params, batch_stats) of
    models.ave_legacy.MMILNetV1. Its adapter_token_downsampler list, built
    and never called, is dropped."""
    ep: Dict = {"swin": convert_swinv2_timm(_scope(sd, "swin."), swin_depths)}
    hp, hbs = convert_htsat(_scope(sd, "htsat."), htsat_depths)
    ep["htsat"] = hp
    ebs: Dict = {"htsat": hbs}
    _legacy_adapters(ep, ebs, sd, convert_dgsct_adapter, n_sites, adapter_kwargs or {})
    params: Dict = {"encoder": ep,
                    "temporal_attn": convert_temporal_attention(_scope(sd, "temporal_attn.")),
                    "cmbs": convert_cmbs(_scope(sd, "CMBS."), inter=inter)}
    return params, {"encoder": ebs}


def convert_mmil_v2(
    sd: Dict[str, np.ndarray],
    *,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    adapter_kwargs: Optional[Dict] = None,
) -> Tuple[Dict, Dict]:
    """Reference MMIL_Net_v2 (LAVisH, the Swin flavor) state_dict ->
    (params, batch_stats) of models.ave_legacy.MMILNetV2."""
    params: Dict = {"swin": convert_swinv2_timm(_scope(sd, "swin."), swin_depths)}
    bs: Dict = {}
    _legacy_adapters(params, bs, sd, convert_lavish_adapter, sum(swin_depths),
                     adapter_kwargs or {})
    p: Flat = {}
    _dense(p, sd, "mlp_class", "mlp_class")
    _dense(p, sd, "mlp_class_2", "mlp_class_2")
    params.update(_unflatten(p))
    return params, bs


# ------------------------------------------------------------- the graft


def graft_backbones(model, *, swin_sd: Optional[Dict[str, np.ndarray]] = None,
                    htsat_sd: Optional[Dict[str, np.ndarray]] = None):
    """Load a timm Swin-V2 and / or an HTS-AT state dict into the backbones
    of a built port model, in place (on whatever device it is): the task
    models' `encoder.swin` / `encoder.htsat`, or `swin` / `htsat` of a model
    without a lock-step encoder (AVQA's grounding model, the LAVisH
    MMIL_Net_v2, whose one Swin-V2 runs both streams). Each load is
    strict within its backbone; HTS-AT's tagging tail is skipped
    (`flax_off_path`). Strip a checkpoint's 'sed_model.' prefix first
    (`strip_prefix`). Returns the model."""
    from avmoe_tpu_torch.convert import load_jax_variables

    host = getattr(model, "encoder", model)
    if htsat_sd is not None and not hasattr(host, "htsat"):
        raise ValueError(f"{type(model).__name__} has no HTS-AT backbone to graft into")
    if swin_sd is not None:
        load_jax_variables(host.swin, {"params": convert_swinv2_timm(
            swin_sd, host.swin.cfg.depths)})
    if htsat_sd is not None:
        hp, hbs = convert_htsat(htsat_sd, host.htsat.cfg.depths)
        load_jax_variables(host.htsat, {"params": hp, "batch_stats": hbs})
    return model


# ---------------------------------------------------------------------- AVS


def _conv3d_1x1(p, sd, src: str, dst: str) -> None:
    """torch Conv3d k=1 (O, I, 1, 1, 1) -> Dense kernel (I, O)."""
    w = sd[f"{src}.weight"]
    _set(p, f"{dst}/kernel", w.reshape(w.shape[0], w.shape[1]).T)
    if f"{src}.bias" in sd:
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])


def convert_tpavi(p, bs, sd, src: str, dst: str) -> None:
    """Reference TPAVIModule ('dot', dim 3) -> heads.avs.TPAVIModule."""
    _dense(p, sd, f"{src}.align_channel", f"{dst}/align_channel")
    for nm in ("g", "theta", "phi"):
        _conv3d_1x1(p, sd, f"{src}.{nm}", f"{dst}/{nm}")
    # W_z = Sequential(Conv3d k1, BatchNorm3d); flax Conv kernel (1, 1, 1, I, O)
    w = sd[f"{src}.W_z.0.weight"]
    _set(p, f"{dst}/W_z_conv/kernel", w.transpose(2, 3, 4, 1, 0))
    _set(p, f"{dst}/W_z_conv/bias", sd[f"{src}.W_z.0.bias"])
    _bn(p, bs, sd, f"{src}.W_z.1", f"{dst}/W_z_bn")
    _ln(p, sd, f"{src}.norm_layer", f"{dst}/norm_layer")


def _residual_conv_unit(p, sd, src: str, dst: str) -> None:
    _conv(p, sd, f"{src}.conv1", f"{dst}/conv1")
    _conv(p, sd, f"{src}.conv2", f"{dst}/conv2")


def convert_avs_temporal_attention(p, sd, src: str, dst: str) -> None:
    """Reference AVS four-scale TemporalAttention ->
    heads.avs.MultiScaleTemporalAttention. Its audio_decoder / video_decoder
    stacks are dropped: the reference computes their outputs and never uses
    them (only the encoder features feed the gates)."""
    for i in range(4):
        _dense(p, sd, f"{src}.v_fc.{i}", f"{dst}/v_fc_{i}")
        convert_bilstm(p, sd, f"{src}.audio_visual_rnn_layer.{i}.audio_rnn",
                       f"{dst}/audio_rnn_{i}")
        convert_bilstm(p, sd, f"{src}.audio_visual_rnn_layer.{i}.visual_rnn",
                       f"{dst}/visual_rnn_{i}")
        for side in ("video", "audio"):
            _dense(p, sd, f"{src}.{side}_encoder.{i}.affine_matrix",
                   f"{dst}/{side}_enc_affine_{i}")
            for j in range(2):
                _enc_dec_layer(
                    p, sd, f"{src}.{side}_encoder.{i}.encoder.layers.{j}",
                    f"{dst}/{side}_encoder_{i}/layer_{j}", "self_attn", "self_attn")
            _dense(p, sd, f"{src}.{side}_gated.{i}.0", f"{dst}/{side}_gated_{i}")


def convert_pred_endecoder(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 12,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    tpavi_stages: Sequence[int] = (0, 1, 2, 3),
    moe_kwargs: Optional[Dict] = None,
) -> Tuple[Dict, Dict]:
    """Full reference AVS Pred_endecoder state_dict (S4 with the default
    'mha' experts; MS3 with moe_kwargs={"self_attention": "token"}) ->
    (params, batch_stats) of models.avs.AVSModel. Unused reference modules
    are dropped: encoder_backbone (a PVT built and never run), the conv1-4
    Classifier_Modules and x*_linear (the forward uses x*_linear_), and the
    temporal attention's decoder stacks."""
    moe_kwargs = dict(moe_kwargs or {})
    # the AVS recipe: no BN, no gate on the audio adapters (the visual ones
    # keep theirs), an nn.MultiheadAttention in each unimodal expert
    moe_kwargs.setdefault("use_bn", False)
    moe_kwargs.setdefault("use_gate", False)
    moe_kwargs.setdefault("self_attention", "mha")
    ep, ebs = convert_lockstep_encoder(
        sd, n_sites=n_sites, swin_depths=swin_depths,
        htsat_depths=htsat_depths, moe_kwargs=moe_kwargs, vis_use_gate=True)
    p: Flat = {}
    bs: Flat = {}
    for i in range(4):
        _dense(p, sd, f"x{i + 1}_linear_", f"stage_proj_{i}")
    _dense(p, sd, "audio_linear", "audio_linear")
    convert_avs_temporal_attention(p, sd, "temporal_attn", "temporal_attn")
    for i in tpavi_stages:
        convert_tpavi(p, bs, sd, f"tpavi_b{i + 1}", f"tpavi_b{i + 1}")
    for i in range(4):
        src = f"path{i + 1}"
        _residual_conv_unit(p, sd, f"{src}.resConfUnit1", f"path_{i}/res1")
        _residual_conv_unit(p, sd, f"{src}.resConfUnit2", f"path_{i}/res2")
    _conv(p, sd, "output_conv.0", "out_conv1")
    _conv(p, sd, "output_conv.2", "out_conv2")
    _conv(p, sd, "output_conv.4", "out_conv3")
    params: Dict = {"encoder": ep, **_unflatten(p)}
    stats: Dict = {"encoder": ebs, **_unflatten(bs)}
    return params, stats


# --------------------------------------------------------- AVVP (MGN heads)


def _grouping_mlp(p, sd, src: str, dst: str) -> None:
    _dense(p, sd, f"{src}.fc1", f"{dst}/fc1")
    _dense(p, sd, f"{src}.fc2", f"{dst}/fc2")


def _proj_attn(p, sd, src: str, dst: str) -> None:
    """Attention / AssignAttention with separate q / k / v projections."""
    for nm in ("q_proj", "k_proj", "v_proj", "proj"):
        _dense(p, sd, f"{src}.{nm}", f"{dst}/{nm}")


def _fused_qkv_attn(p, sd, src: str, dst: str) -> None:
    """Attention with qkv_fuse=True (AttnBlock): the fused (3C, C) qkv
    weight, row blocks [q; k; v], split into the separate projections."""
    w = sd[f"{src}.qkv.weight"]
    b = sd.get(f"{src}.qkv.bias")
    C = w.shape[0] // 3
    for i, nm in enumerate(("q_proj", "k_proj", "v_proj")):
        _set(p, f"{dst}/{nm}/kernel", w[i * C:(i + 1) * C].T)
        if b is not None:
            _set(p, f"{dst}/{nm}/bias", b[i * C:(i + 1) * C])
    _dense(p, sd, f"{src}.proj", f"{dst}/proj")


def convert_grouping_block(p, sd, src: str, dst: str) -> None:
    """GroupingBlock (GroupingBlock_Han is the same class) ->
    heads.grouping.GroupingBlock."""
    for ln in ("norm_tokens", "norm_post_tokens", "norm_x", "norm_new_x"):
        _ln(p, sd, f"{src}.{ln}", f"{dst}/{ln}")
    _grouping_mlp(p, sd, f"{src}.mlp_inter", f"{dst}/mlp_inter")
    # pre_assign_attn is the post-norm CrossAttnBlock (norm_q / norm_k Identity)
    _proj_attn(p, sd, f"{src}.pre_assign_attn.attn", f"{dst}/pre_assign_attn/attn")
    _ln(p, sd, f"{src}.pre_assign_attn.norm2", f"{dst}/pre_assign_attn/norm2")
    _ln(p, sd, f"{src}.pre_assign_attn.norm_post", f"{dst}/pre_assign_attn/norm_post")
    _grouping_mlp(p, sd, f"{src}.pre_assign_attn.mlp", f"{dst}/pre_assign_attn/mlp")
    _proj_attn(p, sd, f"{src}.assign", f"{dst}/assign")
    _grouping_mlp(p, sd, f"{src}.mlp_channels", f"{dst}/mlp_channels")
    if f"{src}.reduction.1.weight" in sd:  # Sequential(norm, Linear) when dim != out_dim
        _ln(p, sd, f"{src}.reduction.0", f"{dst}/reduction_norm")
        _set(p, f"{dst}/reduction_fc/kernel", sd[f"{src}.reduction.1.weight"].T)


def convert_modality_trans(
    sd: Dict[str, np.ndarray], *, depth: int, use_han: bool = False
) -> Dict:
    """ModalityTrans -> heads.grouping.ModalityTrans."""
    p: Flat = {}
    for i in range(depth):
        src, dst = f"blocks.{i}", f"block_{i}"
        _ln(p, sd, f"{src}.norm1", f"{dst}/norm1")
        _fused_qkv_attn(p, sd, f"{src}.attn", f"{dst}/attn")
        _ln(p, sd, f"{src}.norm2", f"{dst}/norm2")
        _grouping_mlp(p, sd, f"{src}.mlp", f"{dst}/mlp")
    if use_han:
        convert_grouping_block(p, sd, "han_encoder", "han_encoder")
    convert_grouping_block(p, sd, "grouping", "grouping")
    return _unflatten(p)


def convert_mgn_net(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 12,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    grouping_depths: Sequence[int] = (3, 3, 6),
    moe_kwargs: Optional[Dict] = None,
) -> Tuple[Dict, Dict]:
    """Full reference MGN_Net state_dict -> (params, batch_stats) of
    models.avvp.MGNModel."""
    moe_kwargs = dict(moe_kwargs or {})
    moe_kwargs.setdefault("use_bn", False)           # the AVVP recipe has no BN
    moe_kwargs.setdefault("self_attention", "bmm")
    ep, ebs = convert_lockstep_encoder(
        _adapter_lists_renamed(sd), n_sites=n_sites, swin_depths=swin_depths,
        htsat_depths=htsat_depths, moe_kwargs=moe_kwargs)
    flat: Flat = {}
    for name in ("fc_a", "fc_v", "fc_st", "fc_fusion",
                 "fc_prob", "fc_prob_a", "fc_prob_v", "fc_cls"):
        _dense(flat, sd, name, name)
    _set(flat, "audio_token", sd["audio_token"])
    _set(flat, "visual_token", sd["visual_token"])
    params: Dict = {"encoder": ep, **_unflatten(flat)}
    d_aud, d_vis, d_av = grouping_depths
    for scope, depth, han in (("audio_cug", d_aud, True),
                              ("visual_cug", d_vis, False),
                              ("av_mcg", d_av, False)):
        params[scope] = convert_modality_trans(_scope(sd, f"{scope}."), depth=depth,
                                               use_han=han)
    return params, {"encoder": ebs}


# --------------------------------------------------------------------- AVQA


def convert_avqa_fusion_net(
    sd: Dict[str, np.ndarray],
    *,
    n_sites: int = 12,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
    moe_kwargs: Optional[Dict] = None,
) -> Tuple[Dict, Dict]:
    """Full reference AVQA_Fusion_Net state_dict -> (params, batch_stats) of
    models.avqa.AVQAFusionModel. The reference's unused fc_a1_pure /
    fc_a2_pure, norm3 and the grounding stage's visual_net are dropped."""
    moe_kwargs = dict(moe_kwargs or {})
    # the AVQA recipe: no BN, no gate on the audio adapters (the visual ones
    # keep theirs), 4 conv groups, 1 cross-modal and 2 unimodal experts
    moe_kwargs.setdefault("use_bn", False)
    moe_kwargs.setdefault("use_gate", False)
    moe_kwargs.setdefault("num_conv_group", 4)
    moe_kwargs.setdefault("num_singlemodal", 2)
    ep, ebs = convert_lockstep_encoder(
        _adapter_lists_renamed(sd), n_sites=n_sites, swin_depths=swin_depths,
        htsat_depths=htsat_depths, moe_kwargs=moe_kwargs, vis_use_gate=True)
    flat: Flat = {}
    for name in ("fc_a1", "fc_a2", "fc_gl", "fc_fusion", "fc_ans",
                 "fc1", "fc2", "fc3", "fc4"):
        _dense(flat, sd, name, name)
    _set(flat, "question_encoder/word2vec/embedding",
         sd["question_encoder.word2vec.weight"])
    _lstm_dir(flat, sd, "question_encoder.lstm", "question_encoder/lstm", "")
    _dense(flat, sd, "question_encoder.fc", "question_encoder/fc")
    # the question-as-query attentions with their flat FFN / norm params
    # (reference names attn_v + linear11/12 + norm1, attn_a + linear21/22 +
    # norm2) -> the attn_v / attn_a submodules
    for dst, mha_src, l1, l2, ln in (("attn_v", "attn_v", "linear11", "linear12", "norm1"),
                                     ("attn_a", "attn_a", "linear21", "linear22", "norm2")):
        _mha(flat, sd, mha_src, f"{dst}/attn", 4)
        _dense(flat, sd, l1, f"{dst}/linear1")
        _dense(flat, sd, l2, f"{dst}/linear2")
        _ln(flat, sd, ln, f"{dst}/norm")
    params: Dict = {"encoder": ep, **_unflatten(flat)}
    return params, {"encoder": ebs}


def convert_grounding_net(
    sd: Dict[str, np.ndarray],
    *,
    swin_depths: Sequence[int] = (2, 2, 18, 2),
    htsat_depths: Sequence[int] = (2, 2, 6, 2),
) -> Tuple[Dict, Dict]:
    """Reference AVQA_AVatt_Grounding state_dict -> (params, batch_stats) of
    models.avqa_grounding.AVQAGroundingModel: the plain frozen backbones (no
    adapters) and the seven trained Dense heads."""
    hp, hbs = convert_htsat(_scope(sd, "htsat."), htsat_depths)
    params: Dict = {"swin": convert_swinv2_timm(_scope(sd, "swin."), swin_depths),
                    "htsat": hp}
    flat: Flat = {}
    for name in ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4"):
        _dense(flat, sd, name, name)
    params.update(_unflatten(flat))
    return params, {"htsat": hbs}
