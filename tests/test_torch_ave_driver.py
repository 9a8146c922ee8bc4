"""The port's training driver against the JAX package's: expert telemetry
and writers, torch checkpoints (round trip, retention, best tracking,
params-only restore, exact resume, weight caches after a restore),
`load_partial`, and the epoch loop driven by the same scripted steps.

No JAX compile: the JAX pieces compared here are host-side (numpy, flax
tree utilities, a jax.random.split per step).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
jnp = jax.numpy

torch.set_num_threads(2)


def _telemetry(seed: int, B: int = 6):
    """Softmax gating stacks (sites, B, E) per stream, plus lb_loss."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, S in (("audio_p1", 8), ("audio_p2", 8), ("video_p1", 8), ("video_p2", 5)):
        logits = rng.randn(S, B, 3).astype(np.float32)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        out[key] = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    out["lb_loss"] = np.float32(0.25)
    return out


def test_expert_tracker_matches_jax(tmp_path):
    from avmoe_tpu.telemetry.experts import ExpertUsageTracker as JTracker

    from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker

    ours, ref = ExpertUsageTracker(3), JTracker(3)
    for seed in (0, 1, 2):
        tele = _telemetry(seed)
        ref.update({k: jnp.asarray(v) for k, v in tele.items()})
        port = {k: torch.from_numpy(np.asarray(v)) for k, v in tele.items()}
        port["stage_tokens"] = [torch.zeros(2, 4, 8)]    # skipped, as lb_loss
        ours.update(port)
    got, want = ours.summary(), ref.summary()
    assert set(got) == set(want) == {"audio_p1", "audio_p2", "video_p1", "video_p2"}
    for key in want:
        for stat in want[key]:
            np.testing.assert_allclose(got[key][stat], want[key][stat], rtol=1e-12)
        np.testing.assert_allclose(got[key]["mean_gating_probs"].sum(-1), 1.0, rtol=1e-6)
    ours.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 12
    for n in names:
        np.testing.assert_allclose(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n),
                                   rtol=1e-12)
    ours.reset()
    assert ours.summary() == {}


def test_writers_match_jax(tmp_path):
    from avmoe_tpu.telemetry import writers as J

    from avmoe_tpu_torch.telemetry import writers as P

    records = [{"epoch": 1, "train_loss": np.float32(0.5), "val_accuracy": 61.25},
               {"epoch": 2, "train_loss": torch.tensor(0.25), "note": "x"}]
    for mod, name in ((P, "port"), (J, "jax")):
        w = mod.MultiWriter(mod.JSONLWriter(str(tmp_path / name / "m.jsonl")),
                            mod.WandbWriter("avmoe"), None)
        for r in records:
            w.log(r if mod is P else {k: (float(v) if torch.is_tensor(v) else v)
                                      for k, v in r.items()})
        w.close()
    read = lambda name: [{k: v for k, v in json.loads(line).items() if k != "time"}
                         for line in open(tmp_path / name / "m.jsonl")]
    assert read("port") == read("jax") == [
        {"epoch": 1.0, "train_loss": 0.5, "val_accuracy": 61.25},
        {"epoch": 2.0, "train_loss": 0.25, "note": "x"}]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class Tiny(nn.Module):
    """A frozen 'swin' layer with a BatchNorm buffer and a trainable head."""

    def __init__(self, seed: int):
        super().__init__()
        torch.manual_seed(seed)
        self.swin = nn.Linear(3, 4)
        self.norm = nn.BatchNorm1d(4)
        self.head = nn.Linear(4, 1)

    def forward(self, x):
        return self.head(torch.tanh(self.norm(self.swin(x))))


def _state(seed: int, accum: int = 2, lr: float = 0.1):
    from avmoe_tpu_torch.config import TrainConfig
    from avmoe_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(lr=lr, lr_mlp=lr, decay=0.5, decay_epoch=1, accum_steps=accum)
    return create_train_state(Tiny(seed), cfg, steps_per_epoch=4)


def _batch(i: int):
    g = torch.Generator().manual_seed(42 + i)
    x = torch.randn(4, 3, generator=g)
    return {"x": x, "y": x.sum(1, keepdim=True) * 0.5}


def _step():
    from avmoe_tpu_torch.train.steps import make_train_step

    def loss_fn(model, batch, generator):
        model.train()
        return ((model(batch["x"]) - batch["y"]) ** 2).mean(), {}

    return make_train_step(loss_fn)


def _flat_state(state):
    """Every tensor and count of a train state, for exact comparison."""
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": torch.as_tensor(v).clone() for k, v in s.items()})
    for i, a in enumerate(state.acc_grads or []):
        out[f"acc.{i}"] = a.clone()
    out["counts"] = torch.tensor([state.step, state.updates, state.mini_step])
    return out


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_full_state_resume_is_exact(tmp_path):
    """5 micro-steps at accum 2 (the save holds a half-accumulated gradient)
    with the StepLR boundary inside (updates_per_epoch 2, decay_epoch 1:
    the LR halves after update 2), save, restore into a model built from
    another seed, 3 more steps: bit-identical to 8 straight steps in
    float32: weights, running stats, Adam moments, accumulation, counts."""
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager

    step = _step()
    straight = _state(0)
    for i in range(8):
        straight, _ = step(straight, _batch(i), None)

    part = _state(0)
    for i in range(5):
        part, _ = step(part, _batch(i), None)
    assert part.mini_step == 1 and part.updates == 2
    assert part.optimizer.param_groups[0]["lr"] == 0.1
    mngr = CheckpointManager(str(tmp_path / "ck"))
    mngr.save(5, part)
    saved = _flat_state(part)

    resumed = mngr.restore(_state(99))
    _assert_same(_flat_state(resumed), saved)
    for i in range(5, 8):
        resumed, _ = step(resumed, _batch(i), None)
    assert resumed.optimizer.param_groups[0]["lr"] == 0.05
    _assert_same(_flat_state(resumed), _flat_state(straight))


def test_checkpoint_retention_and_best(tmp_path):
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager

    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mngr.latest_step() is None and mngr.best_metric() is None
    state = _state(0)
    assert mngr.save_if_best(1, state, 50.0)
    assert not mngr.save_if_best(2, state, 40.0)
    assert mngr.save_if_best(3, state, 50.0)          # ties save (>=)
    for s, m in ((4, 60.0), (5, 70.0)):
        assert mngr.save_if_best(s, state, m)
    assert mngr.all_steps() == [3, 4, 5] and mngr.latest_step() == 5
    with open(tmp_path / "ck" / "best.json") as f:
        assert json.load(f) == {"step": 5, "metric": 70.0}
    with open(tmp_path / "ck" / "5" / "metrics.json") as f:
        assert json.load(f) == {"metric": 70.0}
    # an interrupted save leaves only a temporary directory, never a step
    os.makedirs(tmp_path / "ck" / ".tmp.9.123")
    assert mngr.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(0))


def test_checkpoint_round_trip_and_params_only(tmp_path):
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager

    step = _step()
    state = _state(0, accum=2)
    for i in range(3):
        state, _ = step(state, _batch(i), None)
    mngr = CheckpointManager(str(tmp_path / "ck"))
    mngr.save(3, state)
    payload = mngr.load()
    assert payload["step"] == 3 and payload["updates"] == 1 and payload["mini_step"] == 1
    assert [n for n, _ in payload["trainable"]] == list(state.trainable)

    other = _state(7, accum=4)                       # another accumulation window
    with pytest.raises(ValueError, match="accum_steps"):
        mngr.restore(other)
    restored = mngr.restore(_state(7, accum=4), params_only=True)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], v, rtol=0, atol=0)
    assert restored.step == 0 and restored.acc_grads is None
    # a state of another layout is refused on a full restore
    wrong = _state(0)
    wrong.trainable = dict(reversed(list(wrong.trainable.items())))
    with pytest.raises(ValueError, match="trainable"):
        mngr.restore(wrong)


def test_load_partial_matches_jax():
    from flax import traverse_util

    from avmoe_tpu.checkpoint.manager import CheckpointManager as JM

    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager as PM

    rng = np.random.RandomState(0)
    params = {"fc_a1": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)},
              "fc_ans": {"kernel": np.zeros((2, 4))},
              "enc": {"swin": {"w": np.zeros(3)}, "head": {"w": np.zeros(5)}}}
    donor = {"fc_a1": {"kernel": rng.randn(2, 2), "bias": rng.randn(3)},
             "fc_ans": {"kernel": rng.randn(2, 4)},
             "grd": {"swin": {"w": rng.randn(3)}, "head": {"w": rng.randn(5)}}}
    flat = lambda t: {"/".join(k): v for k, v in traverse_util.flatten_dict(t).items()}
    cases = [dict(exclude=r"fc_ans"), dict(include=r"^fc_"), dict(rename={"grd/": "enc/"}),
             dict(rename={"grd/": "enc/"}, exclude="head"), dict()]
    for kw in cases:
        want = flat(JM.load_partial(params, donor, **kw))
        got = PM.load_partial(flat(params), flat(donor), **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kw} {k}")
        # torch names ('.'-joined) give the same result, under their own keys
        dotted = PM.load_partial({k.replace("/", "."): v for k, v in flat(params).items()},
                                 flat(donor), **kw)
        assert {k.replace(".", "/"): v for k, v in dotted.items()}.keys() == want.keys()
    for kw in (dict(include="nothing"), dict(exclude=".")):
        with pytest.raises(AssertionError, match="matched nothing"):
            JM.load_partial(params, donor, **kw)
        with pytest.raises(AssertionError, match="matched nothing"):
            PM.load_partial(flat(params), flat(donor), **kw)


def test_restore_refreshes_the_frozen_weight_caches(tmp_path):
    """A bf16 model that has run a forward (and so made its bf16 copies of
    the frozen MLP weights) computes with the restored weights after a
    restore: its output equals a fresh model's holding those weights."""
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
    from avmoe_tpu_torch.config import TrainConfig, tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.train.state import create_train_state

    cfg = tiny_ave_config()
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randn(1, 2, cfg.audio_len).astype(np.float32) * 0.1)
    imgs = torch.from_numpy(rng.rand(1, 2, 64, 64, 3).astype(np.float32))
    build = lambda seed: create_train_state(
        AVEModel(cfg, dtype=torch.bfloat16, device="cpu", seed=seed), TrainConfig(accum_steps=1))
    donor = build(1)
    mngr = CheckpointManager(str(tmp_path / "ck"))
    mngr.save(1, donor)
    want = donor.model(wave, imgs)["event_logits"]

    state = build(0)
    before = state.model(wave, imgs)["event_logits"]       # fills the caches
    assert (before - want).abs().max() > 1e-3
    block = state.model.encoder.swin.blocks[0]
    assert block._mlp_cache
    mngr.restore(state)
    torch.testing.assert_close(state.model(wave, imgs)["event_logits"], want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.saves, self.logs = [], []

    def save_if_best(self, step, state, metric):
        self.saves.append((int(step), float(metric)))

    def log(self, rec):
        self.logs.append({k: float(v) for k, v in rec.items()})


class _Counter:
    def __init__(self):
        self.step = 0


def _scripted(port: bool, losses, vals, eval_batches: int):
    """Steps that return scripted metrics: train loss per micro-step, the
    per-epoch validation accuracy on every eval batch, telemetry."""
    wrap = (lambda v: torch.tensor(v)) if port else (lambda v: jnp.asarray(v))
    seen = {"train": 0, "eval": 0}

    def train_step(state, batch, rng):
        assert (isinstance(rng, torch.Generator) if port else rng.shape == (2,))
        state.step += 1
        loss = losses[seen["train"]]
        seen["train"] += 1
        return state, {"loss": wrap(np.float32(loss)), "accuracy": wrap(np.float32(loss / 2))}

    def eval_step(state, batch):
        epoch = seen["eval"] // eval_batches
        seen["eval"] += 1
        tele = {k: wrap(v) for k, v in _telemetry(epoch, B=2).items()}
        return {"accuracy": wrap(np.float32(vals[epoch])), "telemetry": tele}

    return train_step, eval_step


@pytest.mark.parametrize("early_stop", [0, 2])
def test_train_and_evaluate_matches_jax(early_stop):
    from avmoe_tpu.telemetry.experts import ExpertUsageTracker as JTracker
    from avmoe_tpu.train.loop import train_and_evaluate as jax_loop

    from avmoe_tpu_torch.telemetry.experts import ExpertUsageTracker
    from avmoe_tpu_torch.train.loop import train_and_evaluate

    epochs, steps, eval_batches = 7, 5, 2
    rng = np.random.RandomState(3)
    losses = rng.rand(epochs * steps).astype(np.float32).tolist()
    vals = [50.0, 62.5, 62.5, 55.0, 40.0, 70.0, 65.0]
    train_loader, eval_loader = [None] * steps, [None] * eval_batches
    results = []
    for port, loop, tracker in ((True, train_and_evaluate, ExpertUsageTracker(3)),
                                (False, jax_loop, JTracker(3))):
        rec, state = _Recorder(), _Counter()
        train_step, eval_step = _scripted(port, losses, vals, eval_batches)
        extra = dict(device="cpu") if port else {}
        state, best = loop(state=state, train_step=train_step, eval_step=eval_step,
                           train_loader=train_loader, eval_loader=eval_loader, epochs=epochs,
                           seed=1, early_stop=early_stop, checkpoints=rec,
                           expert_tracker=tracker, writer=rec, log_every=2, **extra)
        results.append((best, rec.saves, rec.logs, state.step, tracker.summary()))
    (best, saves, logs, step, summ), (jbest, jsaves, jlogs, jstep, jsumm) = results
    assert best == jbest and saves == jsaves and step == jstep
    assert logs == jlogs
    for key in jsumm:
        for stat in jsumm[key]:
            np.testing.assert_allclose(summ[key][stat], jsumm[key][stat], rtol=1e-12)
    if early_stop:
        assert len(logs) == 5 and best == 62.5          # stalls at epochs 4 and 5
    else:
        assert len(logs) == epochs and best == 70.0
        assert [s for s, _ in saves] == [5, 10, 15, 30]


def test_train_and_evaluate_start_epoch():
    """A resumed run (start_epoch 3 of 4) runs epochs 3 and 4 only."""
    from avmoe_tpu_torch.train.loop import train_and_evaluate

    rec, state = _Recorder(), _Counter()
    train_step, eval_step = _scripted(True, [1.0] * 8, [10.0, 20.0, 30.0, 40.0], 1)
    train_and_evaluate(state=state, train_step=train_step, eval_step=eval_step,
                       train_loader=[None] * 2, eval_loader=[None], epochs=4, writer=rec,
                       start_epoch=3, device="cpu")
    assert [r["epoch"] for r in rec.logs] == [3.0, 4.0] and state.step == 4
