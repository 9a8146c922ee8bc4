"""The parameter gradients of K1b and K2b, on the CPU, with no JAX.

Where a backbone trains (AVS S4 trains HTS-AT), K1b gives the attention
bias's gradient and K2b the MLP's six parameter gradients. On the CPU the
wrappers' autograd Functions run the kernels' plain backward versions,
which this file holds against autograd of the plain forward versions:

  * `window_attention_backward_plain`'s dbias, float64, atol 1e-10, with one
    window a frame (nW = 1, an unshifted block) and several frames a window;
  * `mlp_block_backward_plain`'s dW1, db1, dW2, db2, d ln_w and d ln_b,
    float64, atol 1e-10, both norms, with and without a DropPath scale that
    has zeros;
  * through the modules, float32: the relative-position table of
    `WindowAttentionV1`, the CPB MLP of `WindowAttentionV2` and every
    parameter of a trainable `SwinBlock` of each version, the wrappers
    (Functions) against the plain versions under plain autograd, max |d|
    within 1e-5 of the leaf's largest element (two float32 evaluations of
    sums over hundreds of terms in another order), and the Functions'
    `grad_fn` asserted;
  * float32 master weights with a bf16 input get float32 gradients, within
    2e-2 (1 + |ref|) of plain autograd through the same bf16 forward;
  * one tiny S4 train step calls K1b's and K2b's wrappers as often as
    `avs_backward_launches` plans, every HTS-AT block included.

The S4 step's gradients through these plain backward versions are held
against `jax.value_and_grad` in `tests/test_torch_avs_s4_train.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from avmoe_tpu_torch.kernels.mlp_block import (
    mlp_block, mlp_block_backward_plain, mlp_block_forward_plain, mlp_block_plain)
from avmoe_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_backward_plain, window_attention_plain)

torch.set_num_threads(2)


def _close_f32(a, b, what):
    """Two float32 evaluations of one gradient: max |d| <= 1e-5 max |b|."""
    d, top = (a - b).abs().max().item(), b.abs().max().item()
    assert d <= 1e-5 * top, f"{what}: max |d| {d:.3e}, largest {top:.3e}"


def _f64(*shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


@pytest.mark.parametrize("nW, frames", [(1, 5), (3, 4)])
def test_window_attention_backward_plain_bias_gradient(nW, frames):
    H, N, D = 2, 9, 4
    q, k, v = (0.5 * _f64(frames * nW, H, N, D, seed=s) for s in (1, 2, 3))
    bias = _f64(nW, H, N, N, seed=4)
    bias[..., :4, 5:] -= 100.0 * (nW > 1)          # a shift mask's -100 entries
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = window_attention_plain(*leaves)
    dout = _f64(*out.shape, seed=5)
    ref = torch.autograd.grad(out, leaves, dout)
    got = window_attention_backward_plain(q, k, v, bias, out.detach(), dout, bias_grad=True)
    assert len(got) == 4 and got[3].shape == bias.shape and got[3].dtype == torch.float64
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)
    # without bias_grad: the three input gradients, as before
    assert len(window_attention_backward_plain(q, k, v, bias, out.detach(), dout)) == 3


def _mlp_f64(C):
    return (1 + 0.1 * _f64(C, seed=7), 0.1 * _f64(C, seed=8),
            _f64(4 * C, C, seed=9) / C ** 0.5, 0.1 * _f64(4 * C, seed=10),
            _f64(C, 4 * C, seed=11) / (2 * C ** 0.5), 0.1 * _f64(C, seed=12))


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("pre_norm", [True, False])
def test_mlp_block_backward_plain_parameter_gradients(pre_norm, with_scale):
    C = 8
    x = _f64(3, 5, C, seed=6)
    params = _mlp_f64(C)
    scale = torch.tensor([1 / 0.9, 0.0, 1 / 0.9], dtype=torch.float64) if with_scale else None
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    out = mlp_block_plain(*leaves, pre_norm=pre_norm, scale=scale)
    dy = _f64(*out.shape, seed=13)
    gx, g_lnw, g_lnb, g_w1, g_b1, g_w2, g_b2 = torch.autograd.grad(out, leaves, dy)
    ln_w, ln_b, w1, b1, w2, b2 = params
    _, h1, f, a1, hid = mlp_block_forward_plain(x, *params, pre_norm=pre_norm, scale=scale,
                                                acts=True)
    got = mlp_block_backward_plain(dy, h1, x if pre_norm else f, ln_w, w1.t().contiguous(),
                                   w2.t().contiguous(), pre_norm=pre_norm, scale=scale,
                                   a1=a1, hid=hid)
    ref = (gx, g_w1, g_b1, g_w2, g_b2, g_lnw, g_lnb)
    for name, a, b in zip(("dx", "dW1", "db1", "dW2", "db2", "d ln_w", "d ln_b"), got, ref):
        assert a.shape == b.shape and a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10, msg=name)


def _with_plain_cores(monkeypatch):
    """K1's and K2's wrappers in `ops/swin.py` replaced by their plain
    versions, which autograd then differentiates."""
    import avmoe_tpu_torch.ops.swin as swin

    def mlp(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm, eps=1e-5, scale=None, w1t=None,
            w2t=None):
        return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, eps=eps,
                               scale=scale)

    monkeypatch.setattr(swin, "window_attention", window_attention_plain)
    monkeypatch.setattr(swin, "mlp_block", mlp)


def _block(version: str, seed: int = 0):
    from avmoe_tpu_torch.ops.swin import SwinBlock

    torch.manual_seed(seed)
    kw = dict(pretrained_window=4) if version == "v2" else {}
    block = SwinBlock(16, (8, 8), 2, 4, 2, version=version, **kw)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.2 * torch.randn_like(p))    # a non-zero table, norms off 1 and 0
    return block


def _param_grads(block, x, dy, monkeypatch=None):
    """{name: gradient} of every parameter and of x, one block forward."""
    with pytest.MonkeyPatch.context() as mp:
        if monkeypatch:
            _with_plain_cores(mp)
        xl = x.clone().requires_grad_()
        out = block(xl)
        named = [(n, p) for n, p in block.named_parameters()]
        grads = torch.autograd.grad(out, [xl] + [p for _, p in named], dy, allow_unused=True)
    return out, dict(zip(["x"] + [n for n, _ in named], grads))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_trainable_swin_block_gradients_through_the_kernel_functions(version):
    """A shifted block with every parameter trainable: the relative-position
    table (V1) or the CPB MLP and logit scale (V2), qkv and proj, both norms,
    fc1 and fc2 get the same gradients through K1b's and K2b's Functions as
    through plain autograd of the plain versions."""
    block = _block(version)
    x = torch.randn(3, 64, 16, generator=torch.Generator().manual_seed(1))
    dy = torch.randn(3, 64, 16, generator=torch.Generator().manual_seed(2))
    out, got = _param_grads(block, x, dy)
    _, ref = _param_grads(block, x, dy, monkeypatch=True)
    assert all(g is not None for g in got.values())
    table = ("attn.relative_position_bias_table" if version == "v1"
             else "attn.cpb_fc1.weight")
    for name in ("mlp.fc1.weight", "mlp.fc2.bias", "norm2.weight", table):
        assert got[name].abs().max() > 0, name
    for name in ref:
        _close_f32(got[name], ref[name], name)


def test_trainable_parameters_route_through_the_functions():
    """On the CPU a bias or a weight that needs a gradient takes the autograd
    Functions (the kernels' plain backward versions), whether or not the
    input needs one; the parameters' gradients come out float32 for
    float32 master weights of a bf16 input."""
    q, k, v = (0.5 * _f64(4, 2, 9, 8, seed=s).float() for s in (1, 2, 3))
    bias = _f64(2, 2, 9, 9, seed=4).float().requires_grad_()
    out = window_attention(q, k, v, bias)
    assert "WindowAttentionFn" in type(out.grad_fn).__name__
    dout = _f64(*out.shape, seed=5).float()
    got, = torch.autograd.grad(out, bias, dout)
    ref, = torch.autograd.grad(window_attention_plain(q, k, v, bias), bias, dout)
    _close_f32(got, ref, "dbias")

    C = 16
    x = _f64(4, 6, C, seed=14).bfloat16()
    params = [t.float().requires_grad_() for t in _mlp_f64(C)]
    out = mlp_block(x, *params, pre_norm=True)
    assert "MlpBlockFn" in type(out.grad_fn).__name__ and out.dtype == torch.bfloat16
    dy = _f64(*out.shape, seed=15).bfloat16()
    got = torch.autograd.grad(out, params, dy)
    # plain autograd of the same bf16 forward, through bf16 copies of w1, w2
    leaves = [p.detach().bfloat16() if i in (2, 4) else p.detach()
              for i, p in enumerate(params)]
    leaves = [t.requires_grad_() for t in leaves]
    ref = torch.autograd.grad(mlp_block_plain(x, *leaves, pre_norm=True), leaves, dy)
    for a, b, p in zip(got, ref, params):
        assert a.dtype == torch.float32 and a.shape == p.shape
        assert ((a - b.float()).abs() <= 2e-2 * (1 + b.float().abs())).all()


def test_s4_step_calls_the_backward_wrappers_as_planned(monkeypatch):
    """One tiny S4 train step (HTS-AT trainable) calls K1b's and K2b's
    wrappers as often as `avs_backward_launches` plans: every HTS-AT
    sub-block, and the Swin ones after the first adapter residual; every
    HTS-AT parameter gets a gradient and Swin's stay frozen."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa
    from avmoe_tpu_torch.config import TrainConfig, tiny_avs_config
    from avmoe_tpu_torch.models.avs import (
        AVSModel, avs_backward_launches, avs_frozen_scopes, make_avs_loss_fn)
    from avmoe_tpu_torch.moe.injection import backward_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    counts = {"K1b": 0, "K2b": 0}
    for mod, name, key in ((wa, "window_attention_bwd", "K1b"), (mb, "mlp_block_bwd", "K2b")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _i=inner, _k=key, **k: (
            counts.__setitem__(_k, counts[_k] + 1), _i(*a, **k))[1])
    cfg = tiny_avs_config()
    model = AVSModel(cfg, device="cpu", seed=0)
    scopes = avs_frozen_scopes(cfg)
    assert scopes == ("swin",)
    state = create_train_state(model, TrainConfig(accum_steps=1), frozen_scopes=scopes)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(0)
    B, T, S = 2, cfg.num_segments, cfg.img_size
    batch = dict(images=torch.from_numpy(rng.rand(B, T, S, S, 3).astype(np.float32)),
                 wave=torch.from_numpy(rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1),
                 mask=torch.from_numpy((rng.rand(B, cfg.mask_size, cfg.mask_size) > 0.6)
                                       .astype(np.float32)))
    state, met = make_train_step(make_avs_loss_fn(model))(state, batch,
                                                          torch.Generator().manual_seed(0))
    want = avs_backward_launches(cfg)
    assert counts == want
    frozen = backward_launches(cfg.swin, cfg.htsat, cfg.injection)
    n_htsat = sum(cfg.htsat.depths)
    assert want["K1b"] - frozen["K1b"] > 0 and want["K1b"] <= frozen["K1b"] + n_htsat
    assert np.isfinite(float(met["loss"]))
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, start[n])}
    htsat = {n for n, _ in model.named_parameters() if n.startswith("encoder.htsat.")}
    swin = {n for n, _ in model.named_parameters() if n.startswith("encoder.swin.")}
    assert {n for n in htsat if ".blocks." in n or "block_" in n} <= moved
    assert "encoder.htsat." in " ".join(moved) and not (moved & swin)
