"""The slice as a whole: the port's tiny AVE eval forward vs the JAX
package's AVEModel on the same seeded weights and inputs, the converter's
coverage of the whole variable tree, and the entry points around it.

One JAX AVE compile for the file (a module-scoped fixture).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, max_err, to_jax

from avmoe_tpu_torch.convert import load_jax_variables

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Measured on the CPU with these seeds: max |port - JAX| is 1.7e-6 over the
# logits and 8e-7 over the gating probs; AVE_TOL is the bound checked.
AVE_TOL = dict(rtol=2e-3, atol=1e-3)


@pytest.fixture(scope="module")
def ave():
    from avmoe_tpu.config import tiny_ave_config as jax_tiny
    from avmoe_tpu.models.ave import AVEModel as JAVE

    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    jcfg = jax_tiny()
    rng = np.random.RandomState(0)
    B, T = 2, jcfg.num_segments
    wave = rng.randn(B, T, jcfg.audio_len).astype(np.float32) * 0.1
    imgs = rng.rand(B, T, jcfg.swin.img_size, jcfg.swin.img_size, 3).astype(np.float32)
    jm = JAVE(jcfg)
    variables = jax_variables(jm, jnp.asarray(wave), jnp.asarray(imgs), seed=1)
    ref = jax.jit(lambda v, w, i: jm.apply(v, w, i))(
        to_jax(variables), jnp.asarray(wave), jnp.asarray(imgs))
    pm = AVEModel(tiny_ave_config(), device="cpu", seed=None)
    load_jax_variables(pm, variables)
    out = pm(torch.from_numpy(wave), torch.from_numpy(imgs))
    return dict(variables=variables, ref=jax.tree_util.tree_map(np.asarray, ref),
                out=out, model=pm, wave=wave, imgs=imgs)


@pytest.mark.parametrize("key", ["is_event_logits", "event_logits", "av_score"])
def test_tiny_ave_forward_matches_jax(ave, key):
    ours, ref = ave["out"][key].numpy(), ave["ref"][key]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **AVE_TOL)
    assert max_err(ours, ref) < 1e-4


@pytest.mark.parametrize("key", ["audio_p1", "audio_p2", "video_p1", "video_p2"])
def test_tiny_ave_gating_probs_match_jax(ave, key):
    ours, ref = ave["out"]["telemetry"][key].numpy(), ave["ref"]["telemetry"][key]
    assert ours.shape == ref.shape == (8, 4, 2)
    np.testing.assert_allclose(ours, ref, **AVE_TOL)
    # the noise made every gate non-zero, so the routing is not trivial
    assert np.abs(ours - 0.5).max() > 1e-3


@pytest.fixture(scope="module")
def chain_out(ave):
    """The chain path (AVEModel(..., block_chains=True)) on the same weights."""
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.ave import AVEModel

    pm = AVEModel(tiny_ave_config(), device="cpu", seed=None, block_chains=True)
    pm.load_state_dict(ave["model"].state_dict())
    before = block_chain.launches
    out = pm(torch.from_numpy(ave["wave"]), torch.from_numpy(ave["imgs"]))
    assert block_chain.launches == before      # CPU tensors take the plain version
    return out


@pytest.mark.parametrize("key", ["is_event_logits", "event_logits", "av_score",
                                 "audio_p1", "audio_p2", "video_p1", "video_p2"])
def test_tiny_ave_block_chains_match_jax_and_default_path(ave, chain_out, key):
    tele = key not in ("is_event_logits", "event_logits", "av_score")
    ours = (chain_out["telemetry"] if tele else chain_out)[key].numpy()
    ref = (ave["ref"]["telemetry"] if tele else ave["ref"])[key]
    default = (ave["out"]["telemetry"] if tele else ave["out"])[key].numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **AVE_TOL)
    np.testing.assert_allclose(ours, default, rtol=1e-4, atol=1e-4)


def test_eval_fn_accuracy_matches_jax(ave):
    from avmoe_tpu.metrics.ave import ave_accuracy as jax_accuracy

    from avmoe_tpu_torch.models.ave import make_ave_eval_fn

    rng = np.random.RandomState(9)
    labels = np.eye(29, dtype=np.float32)[rng.randint(0, 29, size=(2, 2))]
    res = make_ave_eval_fn(ave["model"])({
        "wave": torch.from_numpy(ave["wave"]), "images": torch.from_numpy(ave["imgs"]),
        "labels": torch.from_numpy(labels)})
    ref = jax_accuracy(jnp.asarray(ave["ref"]["is_event_logits"]),
                       jnp.asarray(ave["ref"]["event_logits"]), jnp.asarray(labels))
    assert float(res["accuracy"]) == pytest.approx(float(ref))
    assert set(res["telemetry"]) == set(ave["ref"]["telemetry"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_load_jax_variables_uses_every_leaf_but_the_off_path_list(ave):
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    variables = ave["variables"]
    leaves = {(col,) + p for col in variables for p in _flat(variables[col])}
    port = {n for n, _ in ave["model"].named_parameters()}
    port |= {n for n, b in ave["model"].named_buffers()
             if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
    # every leaf of the AVE tree is read (load_jax_variables raised otherwise);
    # an LSTM cell's 12 flax leaves become 3 tensors (2 BiLSTMs x 2 cells)
    assert len(port) == len(leaves) - 4 * (12 - 3)

    # HTS-AT's standalone-tagging tail (in trees from the HTS-AT checkpoint
    # converter) is the only thing skipped; any other stray leaf raises
    pm = AVEModel(tiny_ave_config(), device="cpu", seed=None)
    htsat = dict(variables["params"]["encoder"]["htsat"])
    htsat.update(norm={"scale": np.ones(128), "bias": np.zeros(128)},
                 tscam_conv={"kernel": np.zeros((2, 3, 128, 527)), "bias": np.zeros(527)},
                 head={"kernel": np.zeros((128, 527)), "bias": np.zeros(527)})
    encoder = dict(variables["params"]["encoder"], htsat=htsat)
    with_tail = dict(variables, params=dict(variables["params"], encoder=encoder))
    load_jax_variables(pm, with_tail)
    want = ave["model"].state_dict()
    for name, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    extra = dict(with_tail, params=dict(with_tail["params"], stray={"kernel": np.zeros(2)}))
    with pytest.raises(ValueError, match="1 flax leaves unused by the port"):
        load_jax_variables(pm, extra)
    params = dict(variables["params"])
    cmbs = dict(params["cmbs"])
    del cmbs["classifier"]
    params["cmbs"] = cmbs
    with pytest.raises(KeyError, match="cmbs/classifier"):
        load_jax_variables(pm, dict(variables, params=params))


def test_configs_match_jax_field_by_field():
    from avmoe_tpu import config as jc

    from avmoe_tpu_torch import config as pc

    ported_away = {"remat", "remat_policy", "token_shard_axis"}

    def same(a, b):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for key in ported_away:
            db.pop(key, None)
            for sub in db.values():
                if isinstance(sub, dict):
                    sub.pop(key, None)
        assert da == db

    same(pc.AVEConfig(), jc.AVEConfig())
    same(pc.tiny_ave_config(), jc.tiny_ave_config())


def test_entry_points_raise_when_cuda_is_asked_for_and_absent():
    from avmoe_tpu_torch import resolve_device
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        AVEModel(tiny_ave_config())
    assert resolve_device("cpu").type == "cpu"
