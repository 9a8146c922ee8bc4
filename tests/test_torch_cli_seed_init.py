"""Why the AVVP and AVQA CLIs' first audio adapters blow up at the seeded
init, in both packages, on the CPU.

As for AVE (`tests/test_torch_ave_seed_init.py`): the flax init's zero
biases let SpecAugment's zeroed time stripes give HTS-AT patch tokens that
are all zero, and a LayerNorm's backward at a row of zero variance multiplies
the gradient by 1/sqrt(eps), twice a block. AVVP's audio adapters have
expert gates, which take the blown-up gradients (on the card at full width
their square overflows Adam's float32 second moment, and `audio_moe_p1_0`
and `audio_moe_p2_0` stall as AVE's do); AVQA's audio adapters have no
gate, so every parameter of the first site takes them, and at full width
the second micro-step's reach inf in bf16 and in float32, through the
kernels and their plain versions alike (`tools/cli_seed_init_grads.py`):
the first update makes them NaN.

Here the tiny models (both backbones cut to depths 1-1-1-1, the CLIs' seeds
23 and 1, every expert gate set to 0.5 as after a first update: AVVP's
first-site gradients stay small while its gates are zero, on the card as
here) take their CLI's first batch (the tiny synthetic set, the train
loader's first permutation, batch 2) in train mode with the random draws
off (AVMOE_DETERMINISTIC_TRAIN=1; AVVP's heads' DropPath off and HAN's
Gumbel noise given, as tests/test_torch_avvp_train.py does), mixup λ 0.5, and
two time stripes of 7
frames (the widest SpecAugment draws at the tiny front end) forced into
every clip's log-mel or not, in both packages, with the port's weights
exported to the JAX model. The loss is a seeded linear readout of the
answer / class outputs. The first site's audio adapters' gradients grow
by more than 1e9 with the stripes (measured ~3e12 at this depth, 1e21 at
2-2-2-2), and the JAX gradients (`jax.jit(jax.grad(...))`, one compile for
both models, over the first site's parameters) and the port's agree there
(rtol 2e-3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import to_jax
from torch_train_harness import flat

torch.set_num_threads(2)

DEPTHS = (1, 1, 1, 1)
BATCH = 2
STRIPES = (4, 20)          # first frames of the two forced time stripes
FIRST_SITE = ("audio_moe_p1_0", "audio_moe_p2_0")
GATE = 0.5                 # every expert gate (AVVP's audio and visual, AVQA's visual)


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _tasks():
    """{task: (port model, JAX model, batch, output key, input keys, seed)}."""
    from avmoe_tpu.config import tiny_avqa_config as j_avqa, tiny_avvp_config as j_avvp
    from avmoe_tpu.models.avqa import AVQAFusionModel as JAVQA
    from avmoe_tpu.models.avvp import MGNModel as JMGN

    from avmoe_tpu_torch.config import tiny_avqa_config, tiny_avvp_config
    from avmoe_tpu_torch.data.avqa import SyntheticAVQADataset
    from avmoe_tpu_torch.data.avvp import SyntheticAVVPDataset
    from avmoe_tpu_torch.data.loader import BatchLoader
    from avmoe_tpu_torch.models.avqa import AVQAFusionModel
    from avmoe_tpu_torch.models.avvp import MGNModel

    avvp, avqa = _cut(tiny_avvp_config()), _cut(tiny_avqa_config())
    sets = {
        "avvp": (MGNModel(avvp, device="cpu", seed=23), JMGN(_cut(j_avvp())),
                 SyntheticAVVPDataset(length=8 * BATCH, num_segments=avvp.num_segments,
                                      audio_len=avvp.audio_len, img_size=avvp.swin.img_size,
                                      st_dim=avvp.st_dim),
                 "global_prob", ("wave", "images", "video_st"), 23),
        "avqa": (AVQAFusionModel(avqa, device="cpu", seed=1), JAVQA(_cut(j_avqa())),
                 SyntheticAVQADataset(length=8 * BATCH, num_segments=avqa.num_segments,
                                      audio_len=avqa.audio_len, img_size=avqa.swin.img_size,
                                      qst_vocab=avqa.qst_vocab, max_qst_len=avqa.max_qst_len,
                                      answer_vocab=avqa.answer_vocab),
                 "qa_logits", ("wave", "visual_posi", "visual_nega", "question"), 1),
    }
    out = {}
    for name, (pm, jm, ds, key, keys, seed) in sets.items():
        batch = next(iter(BatchLoader(ds, BATCH, shuffle=True, seed=seed, device="cpu",
                                      num_workers=1)))
        out[name] = (pm, jm, {k: batch[k] for k in keys}, key)
    return out


def _first_site(tree):
    return {k: v for k, v in flat(tree).items() if k[:2] in {("encoder", s) for s in FIRST_SITE}}


@pytest.fixture(scope="module")
def grads():
    import avmoe_tpu.audio.frontend as jfe
    import avmoe_tpu.heads.grouping as jgrouping

    import avmoe_tpu_torch.audio.frontend as pfe
    import avmoe_tpu_torch.heads.grouping as tgrouping
    from avmoe_tpu_torch.convert import export_jax_variables

    tasks = _tasks()
    T = 2
    lam = np.full(BATCH * T, 0.5, np.float32)
    gumbel = np.random.RandomState(5).gumbel(size=(BATCH, T, T)).astype(np.float32)
    for m in tasks["avvp"][0].modules():
        if isinstance(m, tgrouping.AttnBlock):
            m.drop_path = 0.0
    readouts, variables = {}, {}
    for name, (pm, jm, batch, key) in tasks.items():
        with torch.no_grad():      # the expert gates as after the first update: non-zero
            for n, q in pm.named_parameters():
                if n.endswith(".gate"):
                    q.fill_(GATE)
        out = pm(*batch.values())[key]
        readouts[name] = np.random.RandomState(0).randn(*out.shape).astype(np.float32)
        variables[name] = to_jax(export_jax_variables(pm))
    held = {}
    j_fold, p_fold = jfe.reshape_wav2img, pfe.reshape_wav2img

    def jloss(first, keep):
        held["jax"] = keep
        total = 0.0
        for name, (_, jm, batch, key) in tasks.items():
            params = dict(variables[name]["params"])
            params["encoder"] = {**params["encoder"], **first[name]}
            out = jm.apply({"params": params, "batch_stats": variables[name]["batch_stats"]},
                           *(jnp.asarray(v.numpy()) for v in batch.values()), train=True,
                           mixup_lambda=jnp.asarray(lam),
                           rngs={k: jax.random.PRNGKey(i) for i, k in enumerate(
                               ("dropout", "specaug", "gumbel", "router"))},
                           mutable=["batch_stats", "telemetry", "intermediates"])[0]
            total = total + (out[key] * readouts[name]).sum()
        return total

    j_grad = jax.jit(jax.grad(jloss))
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        # AVVP's heads: DropPath off and HAN's Gumbel noise given, on both sides
        mp.setattr(jgrouping, "DropPath", lambda rate: (lambda x, train=False: x))
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(gumbel, dtype))
        mp.setattr(tgrouping, "gumbel_noise",
                   lambda shape, generator, device, dtype: torch.from_numpy(gumbel).to(dtype))
        # the stripes zero whole time frames of the bn0-normalized log-mel,
        # where SpecAugment zeroes them, before the fold into an image
        mp.setattr(jfe, "reshape_wav2img",
                   lambda s, *a: j_fold(s * held["jax"][None, :, None], *a))
        mp.setattr(pfe, "reshape_wav2img",
                   lambda s, *a: p_fold(s * held["port"][None, :, None], *a))
        cfg = tasks["avvp"][0].cfg
        frames = 1 + cfg.audio_len // cfg.htsat.frontend.hop_length
        width = cfg.htsat.frontend.time_drop_width - 1
        for stripes in (False, True):
            keep = np.ones(frames, np.float32)
            if stripes:
                for s in STRIPES:
                    keep[s:s + width] = 0.0
            held["port"] = torch.from_numpy(keep)
            first = {n: {s: v["params"]["encoder"][s] for s in FIRST_SITE}
                     for n, v in variables.items()}
            j = jax.device_get(j_grad(first, jnp.asarray(keep)))
            for name, (pm, _, batch, key) in tasks.items():
                tokens = []
                hook = pm.encoder.htsat.patch_embed.register_forward_hook(
                    lambda mod, args, out: tokens.append(out.detach()))
                pm.zero_grad()
                out = pm(*batch.values(), train=True, mixup_lambda=torch.from_numpy(lam),
                         generator=torch.Generator().manual_seed(0))
                (out[key] * torch.from_numpy(readouts[name])).sum().backward()
                hook.remove()
                rows = tokens[0].reshape(-1, tokens[0].shape[-1])
                with torch.no_grad():          # the port's gradients in the flax tree
                    kept = {n: q.detach().clone() for n, q in pm.named_parameters()}
                    for n, q in pm.named_parameters():
                        q.copy_(torch.zeros_like(q) if q.grad is None else q.grad)
                    port = _first_site(export_jax_variables(pm)["params"])
                    for n, q in pm.named_parameters():
                        q.copy_(kept[n])
                res[name, stripes] = dict(
                    zero_var=float((rows.var(dim=-1) == 0).float().mean()), port=port,
                    jax=_first_site({"encoder": jax.tree_util.tree_map(np.asarray, j[name])}))
    return res


@pytest.mark.parametrize("task", ["avvp", "avqa"])
def test_stripes_blow_up_the_first_audio_site_in_both_packages(grads, task):
    off, on = grads[task, False], grads[task, True]
    assert off["zero_var"] == 0.0 and on["zero_var"] >= 0.2
    base = max(float(np.abs(g).max()) for g in off["jax"].values())
    blown = max(float(np.abs(g).max()) for g in on["jax"].values())
    assert base < 1e2 and blown > 1e9 * base, (base, blown)


@pytest.mark.parametrize("stripes", [False, True], ids=["no_stripes", "stripes"])
@pytest.mark.parametrize("task", ["avvp", "avqa"])
def test_first_site_gradients_match_jax(grads, task, stripes):
    port, ref = grads[task, stripes]["port"], grads[task, stripes]["jax"]
    assert port.keys() == ref.keys() and len(ref) > 10
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        np.testing.assert_allclose(port[k], g, rtol=2e-3, atol=1e-4 * top, err_msg="/".join(k))
