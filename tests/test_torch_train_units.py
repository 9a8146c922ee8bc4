"""Units of the port's train path against the JAX package, on the CPU.

Train-mode BatchNorm (running stats included), the AVE loss, SpecAugment and
mixup with the masks and λ handed in, gradient accumulation against
`optax.MultiSteps`, the gradients of the K1 and K2 plain versions (with a
DropPath scale) by `torch.autograd.gradcheck` in float64 and the plain
versions of K1b and K2b against them, the K1b / K2b launch plan of a train
step, the dropout switches, and the chain path refusing to train. Small
shapes, eager JAX: no model compile.

Tolerances: float32 against JAX rtol 1e-5, atol 1e-6 (one op, sums in
another order); float64 plain backward against autograd atol 1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from avmoe_tpu_torch.kernels.mlp_block import (
    mlp_block, mlp_block_backward_plain, mlp_block_bwd, mlp_block_forward_plain, mlp_block_plain)
from avmoe_tpu_torch.kernels.window_attention import (
    window_attention, window_attention_backward_plain, window_attention_plain)
from avmoe_tpu_torch.ops.dropout import drop_path_scale, dropout
from avmoe_tpu_torch.ops.norm import BatchNorm

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------


def _bn_jax(x, scale, bias, mean, var):
    """The JAX package's BatchNorm in train mode: (y, new mean, new var)."""
    from avmoe_tpu.ops.norm import BatchNorm as JBN

    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    y, upd = JBN(momentum=0.9).apply(variables, jnp.asarray(x), use_running_average=False,
                                     mutable=["batch_stats"])
    return np.asarray(y), np.asarray(upd["batch_stats"]["mean"]), np.asarray(
        upd["batch_stats"]["var"])


def _bn_params(rng, *lead_c):
    return (1 + 0.1 * rng.randn(*lead_c), 0.1 * rng.randn(*lead_c),
            0.1 * rng.randn(*lead_c), 0.5 + np.abs(rng.randn(*lead_c)))


@pytest.mark.parametrize("shape", [(6, 5, 8), (4, 8)])
def test_batchnorm_train_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale, bias, mean, var = (a.astype(np.float32) for a in _bn_params(rng, shape[-1]))
    y_ref, m_ref, v_ref = _bn_jax(x, scale, bias, mean, var)
    bn = BatchNorm(shape[-1])
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    y = bn(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), m_ref, **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), v_ref, **TOL)
    # flax momentum 0.9 on the biased batch variance (torch.nn.BatchNorm: 0.1, unbiased)
    xf = x.reshape(-1, shape[-1]).astype(np.float64)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var + 0.1 * xf.var(axis=0),
                               rtol=1e-5)


def test_stacked_batchnorm_train_matches_jax_per_expert():
    """The adapters' (E, C) stacked form: each expert's statistics over its own rows."""
    rng = np.random.RandomState(1)
    E, B, N, C = 2, 3, 5, 8
    x = rng.randn(E, B, N, C).astype(np.float32)
    x[1] = 3 * x[1] - 1
    scale, bias, mean, var = (a.astype(np.float32) for a in _bn_params(rng, E, C))
    bn = BatchNorm(C, stack=(E,))
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    y = bn(torch.from_numpy(x), train=True).detach().numpy()
    for e in range(E):
        y_ref, m_ref, v_ref = _bn_jax(x[e], scale[e], bias[e], mean[e], var[e])
        np.testing.assert_allclose(y[e], y_ref, **TOL)
        np.testing.assert_allclose(bn.running_mean[e].numpy(), m_ref, **TOL)
        np.testing.assert_allclose(bn.running_var[e].numpy(), v_ref, **TOL)


def test_bn0_train_matches_flax_batchnorm():
    """HTS-AT's bn0 is flax's own nn.BatchNorm(momentum=0.9) on (B, T, mels)."""
    from flax import linen as nn

    rng = np.random.RandomState(2)
    x = (-30 + 15 * rng.randn(4, 12, 16)).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(16)).astype(np.float32), (0.1 * rng.randn(16)).astype(
        np.float32)
    mean, var = (-30 + rng.randn(16)).astype(np.float32), (200 + rng.rand(16)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y_ref, upd = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(16)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    y = bn(torch.from_numpy(x), train=True).detach().numpy()
    # flax applies (x - mean) * inv, the port x * w + b: inputs of about 30
    # dB lose up to 2e-5 to float32 rounding either way
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Loss, SpecAugment, mixup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lb_weight", [0.0, 0.3])
def test_ave_loss_matches_jax(lb_weight):
    from avmoe_tpu.losses.ave import ave_labels as j_labels, ave_loss as j_loss

    from avmoe_tpu_torch.losses.ave import ave_labels, ave_loss

    rng = np.random.RandomState(3)
    B, T, K = 3, 5, 6
    labels = np.zeros((B, T, K + 1), np.float32)
    for b in range(B):
        for t in range(T):
            labels[b, t, rng.choice([b % K, K]) if t else K] = 1.0
    out = {"is_event_logits": rng.randn(B, T).astype(np.float32),
           "event_logits": rng.randn(B, K).astype(np.float32),
           "av_score": rng.randn(B, K).astype(np.float32),
           "telemetry": {"lb_loss": np.float32(0.7)}}
    ref, ref_aux = j_loss({k: (jnp.asarray(v) if k != "telemetry" else
                               {"lb_loss": jnp.asarray(v["lb_loss"])}) for k, v in out.items()},
                          jnp.asarray(labels), lb_weight)
    t_out = {k: (torch.from_numpy(v) if k != "telemetry" else
                 {"lb_loss": torch.tensor(v["lb_loss"])}) for k, v in out.items()}
    loss, aux = ave_loss(t_out, torch.from_numpy(labels), lb_weight)
    np.testing.assert_allclose(float(loss), float(ref), **TOL)
    assert set(aux) == set(ref_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), **TOL)
    bce, ev = ave_labels(torch.from_numpy(labels))
    j_bce, j_ev = j_labels(jnp.asarray(labels))
    np.testing.assert_array_equal(bce.numpy(), np.asarray(j_bce))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(j_ev))


def test_spec_augment_with_jax_masks_matches_jax():
    from avmoe_tpu.audio import frontend as jfe
    from avmoe_tpu.config import _tiny_frontend

    from avmoe_tpu_torch.audio.frontend import apply_spec_augment

    cfg = _tiny_frontend()
    spec = np.random.RandomState(4).randn(6, 33, 16).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jfe.spec_augment(key, jnp.asarray(spec), cfg)
    k_t, k_f = jax.random.split(key)    # the masks spec_augment draws from this key
    tmask = jfe._stripe_mask(k_t, 6, 33, cfg.time_drop_width, cfg.time_stripes_num)
    fmask = jfe._stripe_mask(k_f, 6, 16, cfg.freq_drop_width, cfg.freq_stripes_num)
    out = apply_spec_augment(torch.from_numpy(spec), torch.from_numpy(np.array(tmask)),
                             torch.from_numpy(np.array(fmask)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref) == 0).any()


def test_stripe_mask_draws_stripes_within_their_widths():
    from avmoe_tpu_torch.audio.frontend import stripe_mask

    gen = torch.Generator().manual_seed(0)
    m = stripe_mask(gen, 400, 64, 8, 2, "cpu")
    assert m.shape == (400, 64) and m.dtype == torch.bool
    dropped = (~m).sum(dim=1)
    assert int(dropped.max()) <= 2 * 7 and int(dropped.min()) >= 0
    assert float(dropped.float().mean()) > 3.0     # two stripes of mean width 3.5


def test_mixup_matches_jax():
    from avmoe_tpu.audio import frontend as jfe

    from avmoe_tpu_torch.audio.frontend import get_mix_lambda, mixup

    rng = np.random.RandomState(6)
    x = rng.randn(6, 7, 5).astype(np.float32)
    lam = rng.uniform(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(mixup(torch.from_numpy(x), torch.from_numpy(lam)).numpy(),
                               np.asarray(jfe.mixup(jnp.asarray(x), jnp.asarray(lam))), **TOL)
    lam = get_mix_lambda(torch.Generator().manual_seed(1), 0.5, 4000)
    assert lam.shape == (4000,) and lam.dtype == torch.float32
    assert float(lam.min()) >= 0.0 and float(lam.max()) <= 1.0
    assert abs(float(lam.mean()) - 0.5) < 0.03    # Beta(0.5, 0.5): mean 0.5


# ---------------------------------------------------------------------------
# Optimizer: accumulation, schedule, lr_mlp group
# ---------------------------------------------------------------------------


def test_accumulation_schedule_and_groups_match_optax_multisteps():
    """accum_steps=2 on a two-leaf tree (one 'mlp_class' leaf at lr_mlp), 8
    micro-steps over 2 epochs of 4: the port's TrainState against optax."""
    import optax
    from avmoe_tpu.config import TrainConfig as JTrainConfig
    from avmoe_tpu.train.state import make_optimizer as j_make_optimizer

    from avmoe_tpu_torch.config import TrainConfig
    from avmoe_tpu_torch.train.state import TrainState, make_optimizer, param_groups

    rng = np.random.RandomState(7)
    p0 = {"head": {"kernel": rng.randn(3, 4).astype(np.float32)},
          "mlp_class": {"kernel": rng.randn(5).astype(np.float32)}}
    grads = [{"head": {"kernel": rng.randn(3, 4).astype(np.float32)},
              "mlp_class": {"kernel": rng.randn(5).astype(np.float32)}} for _ in range(8)]
    tcfg = dict(accum_steps=2, lr=1e-2, lr_mlp=3e-3, decay=0.5, decay_epoch=1)
    tx = j_make_optimizer(JTrainConfig(**tcfg), steps_per_epoch=4)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    params = {"head.kernel": torch.nn.Parameter(torch.from_numpy(p0["head"]["kernel"].copy())),
              "mlp_class.kernel": torch.nn.Parameter(
                  torch.from_numpy(p0["mlp_class"]["kernel"].copy()))}
    groups = param_groups(params, TrainConfig(**tcfg), steps_per_epoch=4)
    assert [len(ps) for ps, _ in groups] == [1, 1]
    state = TrainState(model=torch.nn.Module(), trainable=params,
                       optimizer=make_optimizer(groups), schedules=[s for _, s in groups],
                       accum_steps=2)
    for g in grads:
        state.apply_gradients([torch.from_numpy(g["head"]["kernel"]),
                               torch.from_numpy(g["mlp_class"]["kernel"])])
    assert (state.step, state.updates, state.mini_step) == (8, 4, 0)
    # a few float32 ulps of unit-size values: Adam's arithmetic in another order
    np.testing.assert_allclose(params["head.kernel"].detach().numpy(),
                               np.asarray(jp["head"]["kernel"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(params["mlp_class.kernel"].detach().numpy(),
                               np.asarray(jp["mlp_class"]["kernel"]), rtol=1e-6, atol=1e-6)
    # the two groups moved at their own rates
    assert not np.allclose(params["mlp_class.kernel"].detach().numpy(),
                           p0["mlp_class"]["kernel"], atol=1e-3)


def test_step_decay_schedule_counts_applied_updates():
    from avmoe_tpu_torch.train.state import step_decay_schedule

    s = step_decay_schedule(1.0, 0.5, 2, steps_per_epoch=3)
    assert [s(c) for c in range(13)] == [1.0] * 6 + [0.5] * 6 + [0.25]


# ---------------------------------------------------------------------------
# Gradients of the kernels' plain versions, and of K1b / K2b's
# ---------------------------------------------------------------------------


def _f64(*shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def test_window_attention_plain_gradcheck_and_backward_plain():
    q, k, v = (0.5 * _f64(6, 2, 9, 4, seed=s) for s in (1, 2, 3))
    bias = _f64(3, 2, 9, 9, seed=4)
    bias[1:, :, :4, 5:] -= 100.0
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(lambda a, b, c: window_attention_plain(a, b, c, bias),
                                    (q, k, v))
    out = window_attention_plain(q, k, v, bias)
    dout = _f64(*out.shape, seed=5)
    ref = torch.autograd.grad(out, (q, k, v), dout)
    got = window_attention_backward_plain(q.detach(), k.detach(), v.detach(), bias,
                                          out.detach(), dout)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def _mlp_f64(C):
    return (1 + 0.1 * _f64(C, seed=7), 0.1 * _f64(C, seed=8),
            _f64(4 * C, C, seed=9) / C ** 0.5, 0.1 * _f64(4 * C, seed=10),
            _f64(C, 4 * C, seed=11) / (2 * C ** 0.5), 0.1 * _f64(C, seed=12))


@pytest.mark.parametrize("pre_norm", [True, False])
def test_mlp_block_plain_gradcheck_and_backward_plain_with_droppath(pre_norm):
    """The plain K2b, from the plain forward's kept h1 and f, against the
    plain forward's autograd (itself held by gradcheck) in float64."""
    C = 8
    x = _f64(3, 5, C, seed=6).requires_grad_()
    ln_w, ln_b, w1, b1, w2, b2 = _mlp_f64(C)
    scale = torch.tensor([1 / 0.9, 0.0, 1 / 0.9], dtype=torch.float64)
    f = lambda t: mlp_block_plain(t, ln_w, ln_b, w1, b1, w2, b2, pre_norm=pre_norm, scale=scale)
    assert torch.autograd.gradcheck(f, (x,))
    out, h1, fc2 = mlp_block_forward_plain(x.detach(), ln_w, ln_b, w1, b1, w2, b2,
                                           pre_norm=pre_norm, scale=scale)
    assert torch.equal(out, f(x).detach())
    dy = _f64(*out.shape, seed=13)
    ref, = torch.autograd.grad(f(x), x, dy)
    got = mlp_block_backward_plain(dy, h1, x.detach() if pre_norm else fc2, ln_w,
                                   w1.t().contiguous(), w2.t().contiguous(), pre_norm=pre_norm,
                                   scale=scale)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-10)
    # the dropped frame's branch has no gradient: dx = dy there
    torch.testing.assert_close(got[1], dy[1], rtol=0, atol=0)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_mlp_block_forward_plain_keeps_jax_fc1_and_fc2_outputs(version):
    """h1 and f, which K2b reads, are the JAX package's fc1 and fc2 Dense
    outputs of its MLP sub-block, on the same weights (convert.py)."""
    from avmoe_tpu.ops.swin import SwinBlock as JSwinBlock

    from avmoe_tpu_torch.convert import load_jax_variables
    from avmoe_tpu_torch.ops.swin import SwinBlock
    from torch_port_harness import jax_variables, to_jax

    dim, res = 16, 8
    kw = dict(pretrained_window=4) if version == "v2" else {}
    jm = JSwinBlock(dim=dim, input_resolution=(res, res), num_heads=2, window_size=4,
                    shift_size=0, version=version, **kw)
    pm = SwinBlock(dim, (res, res), 2, 4, 0, version=version, **kw)
    x = np.random.RandomState(3).randn(3, res * res, dim).astype(np.float32)
    variables = jax_variables(jm, jnp.asarray(x), seed=5)
    load_jax_variables(pm, variables)
    _, state = jm.apply(to_jax(variables), jnp.asarray(x), method=JSwinBlock.mlp_residual,
                        capture_intermediates=True)
    inter = state["intermediates"]["mlp"]
    want_h1, want_f = (np.asarray(inter[k]["__call__"][0]) for k in ("fc1", "fc2"))
    m = pm.mlp
    _, h1, f = mlp_block_forward_plain(torch.from_numpy(x), pm.norm2.weight.detach(),
                                       pm.norm2.bias.detach(), m.fc1.weight.detach(),
                                       m.fc1.bias.detach(), m.fc2.weight.detach(),
                                       m.fc2.bias.detach(), pre_norm=version == "v1")
    np.testing.assert_allclose(h1.numpy(), want_h1, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), want_f, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("pre_norm", [True, False])
def test_mlp_block_autograd_function_dx_matches_plain_autograd(pre_norm, with_scale):
    """On the CPU the autograd Function runs the plain forward (keeping h1
    and f) and the plain K2b through K2b's wrapper; dx equals plain autograd's."""
    C = 16
    x = _f64(4, 6, C, seed=14).float().requires_grad_()
    w = [t.float() for t in _mlp_f64(C)]
    scale = torch.tensor([1.25, 0.0, 1.0, 0.5]) if with_scale else None
    before = mlp_block_bwd.launches
    out = mlp_block(x, *w, pre_norm=pre_norm, scale=scale)
    assert out.grad_fn is not None and "MlpBlockFn" in type(out.grad_fn).__name__
    dy = _f64(*out.shape, seed=15).float()
    got, = torch.autograd.grad(out, x, dy)
    assert mlp_block_bwd.launches == before    # CPU tensors take the plain version
    ref, = torch.autograd.grad(mlp_block_plain(x, *w, pre_norm=pre_norm, scale=scale), x, dy)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_differentiate_through_their_backward_on_the_cpu(monkeypatch):
    """Where the inputs need a gradient and the weights are frozen, the
    wrappers go through their autograd Functions (K1b / K2b's plain versions
    on the CPU); the gradients equal plain autograd's."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa

    calls = []
    for mod, name in ((wa, "window_attention_bwd"), (mb, "mlp_block_bwd")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _i=inner, _n=name, **k: (
            calls.append(_n), _i(*a, **k))[1])
    q, k, v = (0.5 * _f64(4, 2, 9, 8, seed=s).float().requires_grad_() for s in (1, 2, 3))
    bias = _f64(2, 2, 9, 9, seed=4).float()
    out = window_attention(q, k, v, bias)
    dout = _f64(*out.shape, seed=5).float()
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = torch.autograd.grad(window_attention_plain(q, k, v, bias), (q, k, v), dout)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    C = 8
    x = _f64(2, 3, C, seed=6).float().requires_grad_()
    w = [t.float() for t in (1 + 0.1 * _f64(C, seed=7), 0.1 * _f64(C, seed=8),
                             _f64(4 * C, C, seed=9) / 3, 0.1 * _f64(4 * C, seed=10),
                             _f64(C, 4 * C, seed=11) / 6, 0.1 * _f64(C, seed=12))]
    scale = torch.tensor([0.0, 1.25])
    out = mlp_block(x, *w, pre_norm=False, scale=scale)
    dy = _f64(*out.shape, seed=13).float()
    got, = torch.autograd.grad(out, x, dy)
    ref, = torch.autograd.grad(mlp_block_plain(x, *w, pre_norm=False, scale=scale), x, dy)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert calls == ["window_attention_bwd", "mlp_block_bwd"]


# ---------------------------------------------------------------------------
# The train forward of the model: launch plan, dropout switches, chain path
# ---------------------------------------------------------------------------


def _tiny_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, T = 2, cfg.num_segments
    labels = np.zeros((B, T, cfg.num_classes + 1), np.float32)
    labels[:, :, 1] = 1.0
    return dict(wave=torch.from_numpy(rng.randn(B, T, cfg.audio_len).astype(np.float32) * 0.1),
                images=torch.from_numpy(rng.rand(B, T, cfg.swin.img_size, cfg.swin.img_size,
                                                 3).astype(np.float32)),
                labels=torch.from_numpy(labels))


def test_train_step_backward_calls_follow_the_launch_plan(monkeypatch):
    """One train step of the tiny model calls K1b and K2b's wrappers as often
    as `backward_launches` plans (the sub-blocks before the first adapter
    residual need no gradient), and the frozen backbone gets no gradient."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa
    from avmoe_tpu_torch.config import TrainConfig, tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel, make_ave_eval_fn, make_ave_loss_fn
    from avmoe_tpu_torch.moe.injection import backward_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_eval_step, make_train_step

    counts = {"K1b": 0, "K2b": 0}
    for mod, name, key in ((wa, "window_attention_bwd", "K1b"), (mb, "mlp_block_bwd", "K2b")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _i=inner, _k=key, **k: (
            counts.__setitem__(_k, counts[_k] + 1), _i(*a, **k))[1])
    cfg = tiny_ave_config()
    model = AVEModel(cfg, device="cpu", seed=0)
    state = create_train_state(model, TrainConfig(accum_steps=1))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    step = make_train_step(make_ave_loss_fn(model))
    state, met = step(state, _tiny_batch(cfg), torch.Generator().manual_seed(0))
    assert counts == backward_launches(cfg.swin, cfg.htsat, cfg.injection) == {
        "K1b": 34, "K2b": 35}
    assert np.isfinite(float(met["loss"]))
    assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen)
    assert all(p.grad is None for p in model.parameters())
    # the eval step reads the updated state, gradient-free
    before = dict(counts)
    ev = make_eval_step(make_ave_eval_fn(model))(state, _tiny_batch(cfg))
    assert 0.0 <= float(ev["accuracy"]) <= 100.0 and counts == before


def test_dropout_and_droppath_switches(monkeypatch):
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.delenv("AVMOE_DETERMINISTIC_TRAIN", raising=False)
    y = dropout(x, 0.25, train=True, generator=gen)
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1.0 / 0.75]))
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.03
    assert dropout(x, 0.25, train=False, generator=None) is x
    s = drop_path_scale(4000, 0.1, train=True, generator=gen, device="cpu")
    assert torch.equal(torch.unique(s), torch.tensor([0.0, 1.0 / 0.9]))
    assert drop_path_scale(8, 0.0, train=True, generator=gen, device="cpu") is None
    assert drop_path_scale(8, 0.1, train=False, generator=None, device="cpu") is None
    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    assert dropout(x, 0.25, train=True, generator=None) is x
    # DropPath does not read the switch (neither does the JAX package's)
    assert drop_path_scale(8, 0.1, train=True, generator=gen, device="cpu") is not None
    with pytest.raises(ValueError, match="Generator"):
        drop_path_scale(8, 0.1, train=True, generator=None, device="cpu")


def test_chain_path_refuses_to_train():
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    cfg = tiny_ave_config()
    model = AVEModel(cfg, device="cpu", seed=0, block_chains=True)
    b = _tiny_batch(cfg)
    with pytest.raises(NotImplementedError, match="chain path .* is eval only"):
        model(b["wave"], b["images"], train=True, generator=torch.Generator())


def test_in_kernel_dropout_rates_refuse_to_train(monkeypatch):
    from avmoe_tpu_torch.ops.swin import SwinBlock

    monkeypatch.delenv("AVMOE_DETERMINISTIC_TRAIN", raising=False)
    blk = SwinBlock(16, (8, 8), 2, 4, 0, version="v1", drop=0.1)
    x = torch.randn(2, 64, 16)
    with pytest.raises(NotImplementedError, match="MLP dropout"):
        blk(x, train=True, generator=torch.Generator())
    monkeypatch.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
    assert blk(x, train=True, generator=torch.Generator()).shape == x.shape
