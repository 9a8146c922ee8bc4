"""The port's loss library against the JAX package's, on the CPU:
avmoe_tpu_torch/losses/classification.py (`label_smoothed_bce`,
`asymmetric_loss`), losses/yb.py (`yb_loss`, `yb_loss2` for every
`aug_type`) and losses/contrastive.py (`contrastive_loss`, `info_nce_loss`,
its own `yb_loss` and `yb_loss2`, `mask_info_nce_loss`).

The same numpy-seeded float32 inputs go through both; the losses agree at
rtol 1e-5 and, where a loss is differentiated in training (the
classification losses, the InfoNCE losses), so do their input gradients
(`jax.grad` against autograd). The index arguments include repeated rows
where the function defines what repeats do (yb.py's last-write and summed
bags, contrastive.py's summed negatives).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from avmoe_tpu.losses import classification as jcl
from avmoe_tpu.losses import contrastive as jct
from avmoe_tpu.losses import yb as jyb
from avmoe_tpu_torch.losses import classification as pcl
from avmoe_tpu_torch.losses import contrastive as pct
from avmoe_tpu_torch.losses import yb as pyb

LOSS = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-7)


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


def _probs(seed: int, *shape) -> np.ndarray:
    return _rng(seed).uniform(0.02, 0.98, shape).astype(np.float32)


def _multi_hot(seed: int, rows: int, classes: int, p: float = 0.3) -> np.ndarray:
    t = (_rng(seed).rand(rows, classes) < p).astype(np.float32)
    t[:, 0] = np.where(t.sum(1) == 0, 1.0, t[:, 0])
    return t


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(ours: torch.Tensor, theirs, tol=LOSS):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **tol)


def _same_with_grad(pfn, jfn, x: np.ndarray, *rest):
    """The loss of x (and the rest) and its gradient in x; the JAX side
    jitted (one compile), the non-array arguments static."""
    xt = _t(x).requires_grad_(True)
    loss = pfn(xt, *(_t(r) if isinstance(r, np.ndarray) else r for r in rest))
    (g,) = torch.autograd.grad(loss, xt)
    arrays = [jnp.asarray(r) for r in rest if isinstance(r, np.ndarray)]

    def f(a, arrs):
        it = iter(arrs)
        return jfn(a, *(next(it) if isinstance(r, np.ndarray) else r for r in rest))

    want, want_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(x), arrays)
    _same(loss, want)
    _same(g, want_g, GRAD)


# ------------------------------------------------------------ classification


@pytest.mark.parametrize("smooth", [0.0, 0.1, 0.4])
def test_label_smoothed_bce(smooth):
    _same_with_grad(pcl.label_smoothed_bce, jcl.label_smoothed_bce, _probs(1, 4, 25),
                    _multi_hot(2, 4, 25), smooth)


@pytest.mark.parametrize("kw", [{}, dict(gamma_neg=2.0, gamma_pos=0.0, clip=0.0),
                                dict(clip=0.2, eps=1e-4)])
def test_asymmetric_loss(kw):
    """The focal weight carries no gradient in either package."""
    p = _probs(3, 4, 29)
    p[0, :3] = (1e-9, 0.999, 0.97)                  # the eps floor and the clip shift
    _same_with_grad(lambda a, t: pcl.asymmetric_loss(a, t, **kw),
                    lambda a, t: jcl.asymmetric_loss(a, t, **kw), p, _multi_hot(4, 4, 29))


# --------------------------------------------------------------- yb.py


def _bags(seed: int, B: int = 6, n: int = 4, S: int = 10, C: int = 28):
    rng = _rng(seed)
    all_prob = rng.uniform(0.01, 0.99, (B + n, S, 2, C)).astype(np.float32)
    target = _multi_hot(seed + 1, B, C, 0.1)
    # pair 0 and 1 share row 2 (last write / summed bags), pair 3's targets
    # overlap (not selected)
    audio_idx = np.array([2, 2, 0, 5], np.int64)
    vis_idx = np.array([1, 3, 4, 5], np.int64)
    target[1] = np.eye(C, dtype=np.float32)[7]
    target[2] = np.eye(C, dtype=np.float32)[3]
    target[3] = np.eye(C, dtype=np.float32)[11]
    return all_prob, audio_idx, vis_idx, target


@pytest.mark.parametrize("exp", [False, True])
@pytest.mark.parametrize("pools", [("max", "max"), ("mean", "max"), ("max", "mean")])
def test_yb_loss(exp, pools):
    all_prob, a_idx, v_idx, target = _bags(5)
    kw = dict(exp=exp, pos_pool=pools[0], neg_pool=pools[1])
    ours = pyb.yb_loss(_t(all_prob), _t(a_idx), _t(v_idx), _t(target), **kw)
    want = jax.jit(functools.partial(jyb.yb_loss, **kw))(
        jnp.asarray(all_prob), jnp.asarray(a_idx), jnp.asarray(v_idx), jnp.asarray(target))
    assert float(want) > 0
    _same(ours, want)


def _features(seed: int, n: int = 6, D: int = 16):
    return (_rng(seed).randn(n, D).astype(np.float32), _rng(seed + 1).randn(n, D)
            .astype(np.float32))


@pytest.mark.parametrize("aug_type", ["vision", "audio", "ada", "mimix"])
def test_yb_loss2(aug_type):
    x1, x2 = _features(6)
    target = _multi_hot(8, 8, 28, 0.15)
    kw = dict(prob_x2=_probs(9, 6, 28), sample_idx=np.array([0, 3, 3, 7, 1, 2]),
              rand_idx=np.array([5, 4, 2, 0, 6, 1]), target=target, x1=x1, x2=x2,
              target_pair=(_multi_hot(10, 6, 28, 0.1), _multi_hot(11, 6, 28, 0.1)),
              smooth=0.8, tmp=0.2)
    ours = pyb.yb_loss2(aug_type, **{k: tuple(map(_t, v)) if isinstance(v, tuple)
                                     else _t(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()})
    arrays = {k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
              for k, v in kw.items() if isinstance(v, (tuple, np.ndarray))}
    static = {k: v for k, v in kw.items() if k not in arrays}
    want = jax.jit(lambda a: jyb.yb_loss2(aug_type, **a, **static))(arrays)
    _same(ours, want)


@pytest.mark.parametrize("aug_type", ["mix", "yybag"])
def test_yb_loss2_dead_branches_raise(aug_type):
    with pytest.raises(ValueError):
        pyb.yb_loss2(aug_type)
    with pytest.raises(ValueError):
        jyb.yb_loss2(aug_type)


# ------------------------------------------------------------ contrastive.py


def test_contrastive_loss():
    x0, x1 = _features(12, 8, 5)
    x1[0] = x0[0] + 1e-4                            # below the sqrt floor's reach
    y = (_rng(14).rand(8) > 0.5).astype(np.float32)
    for margin in (0.5, 1.0, 4.0):
        _same_with_grad(lambda a, b, c: pct.contrastive_loss(a, b, c, margin),
                        lambda a, b, c: jct.contrastive_loss(a, b, c, margin), x0, x1, y)


@pytest.mark.parametrize("segments", [10, 3])
def test_info_nce_loss(segments):
    q = _rng(15).randn(3, segments, 12).astype(np.float32)
    k = _rng(16).randn(3, segments, 12).astype(np.float32)
    _same_with_grad(lambda a, b: pct.info_nce_loss(a, b, tau=0.1, segments=segments),
                    lambda a, b: jct.info_nce_loss(a, b, tau=0.1, segments=segments), q, k)


@pytest.mark.parametrize("pad", [0, 3])
def test_mask_info_nce_loss(pad):
    q = _rng(17).randn(8, 2, 6).astype(np.float32)
    k = _rng(18).randn(8, 2, 6).astype(np.float32)
    mask = np.eye(8, dtype=np.float32)[: 8 - pad]
    mask[0, 3] = 1.0
    _same_with_grad(lambda a, b, m: pct.mask_info_nce_loss(a, b, m, tau=0.07),
                    lambda a, b, m: jct.mask_info_nce_loss(a, b, m, tau=0.07), q, k, mask)


@pytest.mark.parametrize("exp", [False, True])
@pytest.mark.parametrize("pools", [("max", "max"), ("mean", "mean")])
def test_contrastive_yb_loss(exp, pools):
    """contrastive.py's own yb_loss: distinct pair rows (its positive bags
    are set, and a repeated set is undefined in both packages), summed
    negatives."""
    all_prob, _, _, target = _bags(19)
    a_idx, v_idx = np.array([2, 0, 1, 5]), np.array([1, 3, 4, 5])
    kw = dict(exp=exp, pos_pool=pools[0], neg_pool=pools[1])
    ours = pct.yb_loss(_t(all_prob), _t(a_idx), _t(v_idx), _t(target), **kw)
    want = jax.jit(functools.partial(jct.yb_loss, **kw))(
        jnp.asarray(all_prob), jnp.asarray(a_idx), jnp.asarray(v_idx), jnp.asarray(target))
    assert float(want) > 0
    _same(ours, want)


@pytest.mark.parametrize("aug_type", ["vision", "audio", "mix", "yybag"])
def test_contrastive_yb_loss2(aug_type):
    K = 3
    p1, p2 = _probs(20, 4 * K + 1, 28), _probs(21, 4 * K + 1, 28)
    target = _multi_hot(22, 6, 28, 0.15)
    rand_idx, sample_idx = np.array([4, 0, 2]), np.array([1, 1, 5])
    ours = pct.yb_loss2(_t(p1), _t(p2), _t(rand_idx), _t(sample_idx), _t(target),
                        aug_type=aug_type)
    want = jax.jit(functools.partial(jct.yb_loss2, aug_type=aug_type))(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(rand_idx), jnp.asarray(sample_idx),
        jnp.asarray(target))
    _same(ours, want)


def test_contrastive_yb_loss2_unknown_flavor_raises():
    args = [torch.zeros(4, 3)] * 2 + [torch.zeros(1, dtype=torch.long)] * 2 + [torch.zeros(2, 3)]
    with pytest.raises(ValueError):
        pct.yb_loss2(*args, aug_type="ada")
