"""The AVVP slice's pieces against the JAX package, on the CPU in float32:
the bmm unimodal expert and a BN-free MoEAdapter with the load-balance loss
(at a stage-0-like shape with a wide softmax and at a small one), each
grouping module with the gradients of its inputs and parameters (the same
Gumbel noise on both sides where it draws), avvp_loss, and the F1 metrics
(exactly). Module variables are seeded noise (`torch_port_harness`), so
every gate and gate_av is non-zero.

Tolerances: activations and gradients rtol 2e-3 with an atol of 1e-4 of the
largest reference value (gradients of a sum over thousands of terms have
no natural scale of their own); losses rtol 5e-3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, max_err, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)

LOSS_RTOL = 5e-3


def _close(ours, ref, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    atol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=atol, err_msg=what)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_param_grads(model):
    """The port's parameter gradients as a flax tree (each gradient moved
    into its parameter for the export)."""
    params = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for p in params.values():
            p.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
        # copies: the exported arrays share the parameters' memory
        out = {k: v.copy() for k, v in _flat(export_jax_variables(model)["params"]).items()}
        for n, p in params.items():
            p.copy_(saved[n])
    return out


def _compare_with_grads(j_fn, variables, t_module, t_fn, inputs, seed=0):
    """j_fn(variables, *xs) -> array and t_fn(*xs) -> tensor compute the same
    function; check the output, the gradients of <out, cot> with respect to
    every input and every parameter. Returns the largest output error."""
    t_module.zero_grad(set_to_none=True)
    load_jax_variables(t_module, variables)
    xs = [np.asarray(x, np.float32) for x in inputs]

    def j_loss(params, *jx):
        return j_fn(dict(variables, params=params), *jx)

    j_out, vjp = jax.vjp(j_loss, to_jax(variables["params"]), *map(jnp.asarray, xs))
    cot = np.random.RandomState(seed).randn(*j_out.shape).astype(np.float32)
    j_grads = vjp(jnp.asarray(cot))
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    t_out = t_fn(*tx)
    _close(t_out.detach().numpy(), j_out, "output")
    (t_out * torch.from_numpy(cot)).sum().backward()
    for i, (a, b) in enumerate(zip(tx, j_grads[1:])):
        _close(a.grad.numpy(), b, f"input {i} gradient")
    ours, ref = _port_param_grads(t_module), _flat(j_grads[0])
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k], "/".join(k) + " gradient")
    return max_err(t_out.detach().numpy(), j_out)


# ---------------------------------------------------------------------------
# The bmm expert and the BN-free MoEAdapter
# ---------------------------------------------------------------------------

# (B, N, C, x scale): stage 0 of the audio side (4096 tokens at 96 channels),
# x scaled so that a row's logits spread over the whole row (diagonal ~2.2,
# off-diagonal std ~0.2: a wide softmax); and a small shape
EXPERT_SHAPES = [(2, 4096, 96, 0.15), (3, 16, 8, 1.0)]


def _adapter_cfg(jax_side: bool, **kw):
    if jax_side:
        from avmoe_tpu.config import AdapterConfig
    else:
        from avmoe_tpu_torch.config import AdapterConfig
    return AdapterConfig(use_bn=False, self_attention="bmm", **kw)


@pytest.mark.parametrize("B,N,C,scale", EXPERT_SHAPES, ids=["stage0", "small"])
def test_bmm_unimodal_expert_matches_jax(B, N, C, scale):
    from avmoe_tpu.moe.adapter import UnimodalExpert as JExpert, _vmap_experts

    from avmoe_tpu_torch.moe.adapter import UnimodalExpert

    E = 2
    x = (np.random.RandomState(1).randn(B, N, C) * scale).astype(np.float32)
    jm = _vmap_experts(JExpert, E, dim=C, cfg=_adapter_cfg(True))
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(x), False, False, seed=2)
    assert set(variables["params"]) >= {"gate_av", "gate", "bottleneck"}
    assert "batch_stats" not in variables or not variables["batch_stats"]
    pm = UnimodalExpert(C, _adapter_cfg(False), E)
    err = _compare_with_grads(lambda v, a: jm.apply(v, a, a, False, False), variables, pm,
                              lambda a: pm(a, a), [x])
    assert err < 1e-4


def test_bmm_expert_contracts_the_transposed_attention():
    """res_j = sum_i att[i, j] x_i (att^T x), not att x: with a one-hot x the
    two differ, and the port follows the transposed one."""
    from avmoe_tpu_torch.moe.adapter import UnimodalExpert

    cfg = dataclasses.replace(_adapter_cfg(False), before_layernorm=False,
                              post_layernorm=False, use_gate=False)
    pm = UnimodalExpert(4, cfg, 1)
    x = torch.tensor([[[3.0, 0, 0, 0], [0, 1.0, 0, 0], [1.0, 1.0, 0, 0]]])
    with torch.no_grad():
        pm.gate_av.fill_(1.0)
        att = torch.softmax(x @ x.transpose(1, 2), dim=-1)
        want = x + att.transpose(1, 2) @ x
        # the bottleneck is linear: compare what enters it
        seen = []
        pm.bottleneck.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
        pm(x, x)
    torch.testing.assert_close(seen[0][0], want)
    assert (want - (x + att @ x)).abs().max() > 0.1


def test_mha_and_token_experts_are_not_ported():
    """Since the AVS slice both are ported (held against JAX in
    tests/test_torch_avs_units.py): they build with their own parameters,
    and a kind the JAX package does not have raises."""
    from avmoe_tpu_torch.moe.adapter import UnimodalExpert

    params = {"mha": {"self_attention.query.kernel", "self_attention.out.bias"},
              "token": {"latent_tokens", "gate_self"}}
    for kind, names in params.items():
        cfg = dataclasses.replace(_adapter_cfg(False), self_attention=kind)
        assert names <= {n for n, _ in UnimodalExpert(8, cfg, 1).named_parameters()}
    cfg = dataclasses.replace(_adapter_cfg(False), self_attention="lstm")
    with pytest.raises(ValueError, match="lstm"):
        UnimodalExpert(8, cfg, 1)


# (B, N, C, M, C_other, scale): stage 0's audio adapter and a small one
ADAPTER_SHAPES = [(2, 4096, 96, 2304, 192, 0.15), (3, 16, 16, 9, 24, 1.0)]


@pytest.mark.parametrize("compat", [True, False], ids=["lb_compat", "lb_kl"])
@pytest.mark.parametrize("B,N,C,M,Co,scale", ADAPTER_SHAPES, ids=["stage0", "small"])
def test_bn_free_moe_adapter_with_lb_loss_matches_jax(B, N, C, M, Co, scale, compat):
    from avmoe_tpu.config import MoEConfig as JMoEConfig
    from avmoe_tpu.moe.adapter import MoEAdapter as JAdapter

    from avmoe_tpu_torch.config import MoEConfig
    from avmoe_tpu_torch.moe.adapter import MoEAdapter

    rng = np.random.RandomState(3)
    x = (rng.randn(B, N, C) * scale).astype(np.float32)
    other = rng.randn(B, M, Co).astype(np.float32)
    kw = dict(load_balance_loss=True, lb_loss_compat=compat)
    jm = JAdapter(C, Co, N, M, JMoEConfig(adapter=_adapter_cfg(True), **kw))
    variables = jax_variables(jm, jnp.asarray(x), jnp.asarray(other), seed=4)
    pm = MoEAdapter(C, Co, N, M, MoEConfig(adapter=_adapter_cfg(False), **kw))
    j_aux = jax.tree_util.tree_map(
        np.asarray, jm.apply(to_jax(variables), jnp.asarray(x), jnp.asarray(other))[1])

    def j_fn(v, a, o):
        out, aux = jm.apply(v, a, o)
        return out + aux["lb_loss"]

    def t_fn(a, o):
        out, aux = pm(a, o)
        t_fn.aux = aux
        return out + aux["lb_loss"]

    _compare_with_grads(j_fn, variables, pm, t_fn, [x, other])
    _close(t_fn.aux["gating_probs"].detach().numpy(), j_aux["gating_probs"], "gating probs")
    assert float(t_fn.aux["lb_loss"]) == pytest.approx(float(j_aux["lb_loss"]), rel=LOSS_RTOL)
    # no BatchNorm anywhere in the adapter
    assert not [n for n, _ in pm.named_buffers() if "running" in n]


# ---------------------------------------------------------------------------
# Grouping heads
# ---------------------------------------------------------------------------

D, HEADS = 32, 8


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def fixed_gumbel(monkeypatch):
    """The same Gumbel noise on both sides: the JAX module's
    jax.random.gumbel draw and the port's `gumbel_noise` return it."""
    import avmoe_tpu_torch.heads.grouping as tg

    box = {}

    def set_noise(noise):
        box["noise"] = np.asarray(noise, np.float32)

    def j_gumbel(key, shape, dtype=jnp.float32):
        assert tuple(shape) == box["noise"].shape
        return jnp.asarray(box["noise"], dtype)

    def t_gumbel(shape, generator, device, dtype):
        assert tuple(shape) == box["noise"].shape
        return torch.from_numpy(box["noise"]).to(device=device, dtype=dtype)

    monkeypatch.setattr(jax.random, "gumbel", j_gumbel)
    monkeypatch.setattr(tg, "gumbel_noise", t_gumbel)
    return set_noise


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_gumbel_softmax_matches_jax(fixed_gumbel, hard, axis):
    from avmoe_tpu.heads.grouping import gumbel_softmax as j_gs

    from avmoe_tpu_torch.heads.grouping import gumbel_softmax

    logits, noise = _x(3, 6, 5, seed=1), np.random.RandomState(2).gumbel(size=(3, 6, 5))
    fixed_gumbel(noise)
    cot = _x(3, 6, 5, seed=3)
    j_out, vjp = jax.vjp(lambda l: j_gs(jax.random.PRNGKey(0), l, tau=0.7, hard=hard, axis=axis),
                         jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    out = gumbel_softmax(t, 0.7, hard, dim=axis, generator=torch.Generator())
    _close(out.detach().numpy(), j_out)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(t.grad.numpy(), vjp(jnp.asarray(cot))[0])
    # the noise can be handed in as well, with no generator
    given = gumbel_softmax(t.detach(), 0.7, hard, dim=axis, noise=torch.from_numpy(noise))
    torch.testing.assert_close(given, out.detach())
    if hard:
        assert set(np.unique(out.detach().numpy().round(6))) <= {0.0, 1.0}


def test_gumbel_softmax_needs_a_generator_or_noise():
    from avmoe_tpu_torch.heads.grouping import gumbel_softmax

    with pytest.raises(ValueError, match="Generator"):
        gumbel_softmax(torch.zeros(2, 3))
    a = gumbel_softmax(torch.zeros(4, 50), generator=torch.Generator().manual_seed(0))
    b = gumbel_softmax(torch.zeros(4, 50), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b)
    assert (a.argmax(-1) != a.argmax(-1)[0]).any()        # the noise broke the ties


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_proj_attention_matches_jax(cross):
    from avmoe_tpu.heads.grouping import ProjAttention as J

    from avmoe_tpu_torch.heads.grouping import ProjAttention

    q, k = _x(2, 7, D, seed=1), _x(2, 5, D, seed=2)
    jm, pm = J(D, HEADS), ProjAttention(D)
    if cross:
        v = jax_variables(jm, jnp.asarray(q), jnp.asarray(k), seed=5)
        _compare_with_grads(lambda vv, a, b: jm.apply(vv, a, b), v, pm, pm, [q, k])
    else:
        v = jax_variables(jm, jnp.asarray(q), seed=5)
        _compare_with_grads(lambda vv, a: jm.apply(vv, a), v, pm, pm, [q])


def test_attn_block_matches_jax():
    from avmoe_tpu.heads.grouping import AttnBlock as J

    from avmoe_tpu_torch.heads.grouping import AttnBlock

    x = _x(2, 9, D, seed=1)
    # DropPath 0.1 as ModalityTrans builds it: the identity in eval
    jm, pm = J(D, HEADS, drop_path=0.1), AttnBlock(D, drop_path=0.1)
    v = jax_variables(jm, jnp.asarray(x), seed=6)
    _compare_with_grads(lambda vv, a: jm.apply(vv, a), v, pm, pm, [x])


def test_attn_block_drop_path_drops_whole_samples_in_train():
    from avmoe_tpu_torch.heads.grouping import AttnBlock

    pm = AttnBlock(D, drop_path=0.5)
    x = torch.from_numpy(_x(64, 3, D, seed=1))
    with torch.no_grad():
        ev = pm(x)
        tr = pm(x, train=True, generator=torch.Generator().manual_seed(0))
    # a sample whose two branches were both dropped comes out as it went in
    both_dropped = (tr - x).abs().amax(dim=(1, 2)) == 0
    assert 0 < int(both_dropped.sum()) < 64
    assert ((ev - x).abs().amax(dim=(1, 2)) > 0).all()


def test_cross_attn_block_matches_jax():
    from avmoe_tpu.heads.grouping import CrossAttnBlock as J

    from avmoe_tpu_torch.heads.grouping import CrossAttnBlock

    q, k = _x(2, 6, D, seed=1), _x(2, 11, D, seed=2)
    jm, pm = J(D, HEADS), CrossAttnBlock(D)
    v = jax_variables(jm, jnp.asarray(q), jnp.asarray(k), seed=7)
    _compare_with_grads(lambda vv, a, b: jm.apply(vv, a, b), v, pm, pm, [q, k])


@pytest.mark.parametrize("mode", ["soft", "hard", "gumbel_train"])
def test_assign_attention_matches_jax(fixed_gumbel, mode):
    from avmoe_tpu.heads.grouping import AssignAttention as J

    from avmoe_tpu_torch.heads.grouping import AssignAttention

    q, k = _x(2, 5, D, seed=1), _x(2, 8, D, seed=2)
    hard, gumbel = mode != "soft", mode == "gumbel_train"
    train = mode == "gumbel_train"
    fixed_gumbel(np.random.RandomState(3).gumbel(size=(2, 5, 8)))
    jm, pm = J(D, hard=hard, gumbel=gumbel), AssignAttention(D, hard=hard, gumbel=gumbel)
    v = jax_variables(jm, jnp.asarray(q), jnp.asarray(k), seed=8)
    rngs = {"gumbel": jax.random.PRNGKey(0)}
    gen = torch.Generator()

    def j_fn(vv, a, b):
        out, attn = jm.apply(vv, a, b, train=train, return_attn=True, rngs=rngs)
        return jnp.concatenate([out, attn["soft"], attn["hard"]], axis=-1)

    def t_fn(a, b):
        out, attn = pm(a, b, train=train, return_attn=True, generator=gen)
        return torch.cat([out, attn["soft"], attn["hard"]], dim=-1)

    _compare_with_grads(j_fn, v, pm, t_fn, [q, k])


@pytest.mark.parametrize("mode", ["soft", "han_gumbel_train", "han_hard_eval"])
def test_grouping_block_matches_jax(fixed_gumbel, mode):
    from avmoe_tpu.heads.grouping import GroupingBlock as J

    from avmoe_tpu_torch.heads.grouping import GroupingBlock

    # HAN: 4 tokens grouped against the other modality's 4 (S1 = S2 = T);
    # the head's grouping: 6 tokens into 25 groups from 25 class tokens
    han = mode != "soft"
    L, S1, S2 = (4, 4, 4) if han else (6, 25, 25)
    x, g = _x(2, L, D, seed=1), _x(2, S1, D, seed=2)
    train = mode == "han_gumbel_train"
    fixed_gumbel(np.random.RandomState(3).gumbel(size=(2, S2, L)))
    jm = J(D, D, HEADS, S1, S2, hard=han, gumbel=han)
    pm = GroupingBlock(D, S1, S2, hard=han, gumbel=han)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(g), seed=9)
    rngs = {"gumbel": jax.random.PRNGKey(0)}

    def j_fn(vv, a, b):
        out, attn = jm.apply(vv, a, b, train=train, return_attn=True, rngs=rngs)
        return jnp.concatenate([out, attn["soft"]], axis=-1)

    def t_fn(a, b):
        out, attn = pm(a, b, train=train, return_attn=True, generator=torch.Generator())
        return torch.cat([out, attn["soft"]], dim=-1)

    _compare_with_grads(j_fn, v, pm, t_fn, [x, g])


@pytest.mark.parametrize("mode", ["audio_han_train", "audio_han_eval", "visual", "av_3d"])
def test_modality_trans_matches_jax(fixed_gumbel, mode):
    """audio_cug (HAN against the visual tokens, Gumbel in train), visual_cug,
    and av_mcg, whose group tokens are (B, 25, C) features."""
    from avmoe_tpu.heads.grouping import ModalityTrans as J

    from avmoe_tpu_torch.heads.grouping import ModalityTrans

    T, B = 4, 2
    han, train = mode.startswith("audio"), mode == "audio_han_train"
    x = _x(B, 25 if mode == "av_3d" else T, D, seed=1)
    tok = _x(B, 25, D, seed=2) if mode == "av_3d" else _x(25, D, seed=2)
    other = _x(B, T, D, seed=3)
    fixed_gumbel(np.random.RandomState(4).gumbel(size=(B, T, T)))
    # DropPath off in train (its masks cannot match); the identity in eval
    dp = 0.0 if train else 0.1
    jm = J(D, depth=2, num_heads=HEADS, use_han=han, drop_path=dp)
    pm = ModalityTrans(D, 2, use_han=han, num_other_tokens=T, drop_path=dp)
    args = [x, tok] + ([other] if han else [])
    v = jax_variables(jm, *map(jnp.asarray, args), seed=10)
    assert ("han_encoder" in v["params"]) == han
    rngs = {"gumbel": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

    def j_fn(vv, *a):
        out, attn, x_attn = jm.apply(vv, *a, train=train, return_attn=True, rngs=rngs)
        return jnp.concatenate([out.reshape(B, -1), attn["soft"].reshape(B, -1),
                                x_attn.reshape(B, -1)], axis=-1)

    def t_fn(*a):
        out, attn, x_attn = pm(*a, train=train, return_attn=True, generator=torch.Generator())
        return torch.cat([out.reshape(B, -1), attn["soft"].reshape(B, -1),
                          x_attn.reshape(B, -1)], dim=-1)

    _compare_with_grads(j_fn, v, pm, t_fn, args)


# ---------------------------------------------------------------------------
# Loss and metrics
# ---------------------------------------------------------------------------


def _outputs(seed):
    rng = np.random.RandomState(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    out = {k: sig(2 * rng.randn(3, 25)).astype(np.float32)
           for k in ("global_prob", "a_prob", "v_prob")}
    out["global_prob"][0, :3] = [0.0, 1.0, 1e-9]          # the clip to [eps, 1 - eps]
    out.update(aud_cls_logits=rng.randn(25, 25).astype(np.float32),
               vis_cls_logits=rng.randn(25, 25).astype(np.float32),
               telemetry={"lb_loss": np.float32(66.5 + rng.rand())})
    labels = (rng.rand(3, 25) < 0.2).astype(np.float32)
    return out, labels


@pytest.mark.parametrize("lb_weight", [1.0, 0.0, 0.3])
def test_avvp_loss_matches_jax(lb_weight):
    from avmoe_tpu.losses.avvp import avvp_loss as j_loss

    from avmoe_tpu_torch.losses.avvp import avvp_loss

    out, labels = _outputs(0)
    t_out = {k: (torch.from_numpy(v) if k != "telemetry"
                 else {"lb_loss": torch.tensor(v["lb_loss"])}) for k, v in out.items()}
    loss, aux = avvp_loss(t_out, torch.from_numpy(labels), lb_weight=lb_weight)
    j_loss_v, j_aux = j_loss(jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(labels),
                             lb_weight=lb_weight)
    assert float(loss) == pytest.approx(float(j_loss_v), rel=LOSS_RTOL)
    assert set(aux) == set(j_aux)
    for k in j_aux:
        assert float(aux[k]) == pytest.approx(float(j_aux[k]), rel=LOSS_RTOL), k


def test_binary_cross_entropy_matches_jax():
    from avmoe_tpu.losses.classification import binary_cross_entropy as j_bce

    from avmoe_tpu_torch.losses.classification import binary_cross_entropy

    rng = np.random.RandomState(1)
    p = rng.rand(4, 25).astype(np.float32)
    p[0, :2] = [0.0, 1.0]
    t = (rng.rand(4, 25) < 0.5).astype(np.float32)
    ours = float(binary_cross_entropy(torch.from_numpy(p), torch.from_numpy(t)))
    assert ours == pytest.approx(float(j_bce(jnp.asarray(p), jnp.asarray(t))), rel=LOSS_RTOL)


def _grids(rng, n=25, T=10, p=0.3):
    return (rng.rand(n, T) < p).astype(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_segment_and_event_level_f1_match_jax_exactly(seed):
    from avmoe_tpu.metrics import avvp as jmet

    from avmoe_tpu_torch.metrics import avvp as met

    rng = np.random.RandomState(seed)
    args = [_grids(rng, p=p) for p in (0.3, 0.4, 0.1, 0.3, 0.5, 0.2)]
    if seed == 0:
        args = [np.zeros_like(a) for a in args]               # all true negatives
    for name in ("segment_level", "event_level"):
        assert getattr(met, name)(*args) == getattr(jmet, name)(*args), name
    for row in args[0]:
        assert met.extract_events(row) == jmet.extract_events(row)


def test_avvp_evaluator_summary_matches_jax_exactly():
    from avmoe_tpu.metrics.avvp import AVVPEvaluator as J

    from avmoe_tpu_torch.metrics.avvp import AVVPEvaluator

    rng = np.random.RandomState(7)
    ours, ref = AVVPEvaluator(), J()
    for _ in range(6):
        gp, ap, vp = rng.rand(25), rng.rand(10, 25), rng.rand(10, 25)
        ga, gv = _grids(rng), _grids(rng)
        ours.add_clip(gp, ap, vp, ga, gv)
        ref.add_clip(gp, ap, vp, ga, gv)
    assert ours.summary() == ref.summary()
    assert AVVPEvaluator().summary() == J().summary()
