"""Why the AVE CLI's first audio adapters can stall at the seeded init, in
both packages, on the CPU.

`cli/train_ave.py` builds `AVEModel` from seed 999 with the flax init: zero
biases and zero adapter gates. SpecAugment's zeroed time stripes then give
HTS-AT patch tokens that are all zero (a zero patch through a bias-free
conv), and a LayerNorm's backward at a row of zero variance multiplies the
gradient by 1/sqrt(eps), twice a block. Here the tiny AVE model (both
backbones cut to depths 2-2-2-2) takes the CLI's first batch (the tiny
synthetic set, the train loader's first permutation, batch 2) in train mode
with the random draws off (AVMOE_DETERMINISTIC_TRAIN=1) and two time
stripes of 7 frames (the widest SpecAugment draws at the tiny front end)
forced into every clip's log-mel, in both packages, with the port's seeded
weights exported to the JAX model. The loss is a seeded linear readout of
the event logits. The JAX gradient (`jax.jit(jax.grad(...))`, one compile
for both settings) and the port's agree on every audio adapter gate (rtol
2e-3; measured: within 3.6e-4 of the gate's largest gradient without the
stripes, 8.6e-5 with them). Measured: a quarter of the
patch tokens have zero variance with the stripes (none without), and the
first site's audio gates (audio_moe_p1_0, audio_moe_p2_0) get gradients of
up to 3.4e9 against up to 2.4 without: 1e9 times larger at this depth and
width. On the card at full width the CLI's gradients overflow Adam's float32
second moment at those two adapters (`chip_smoke.py` `phase_ave_cli`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import to_jax

torch.set_num_threads(2)

DEPTHS = (2, 2, 2, 2)
BATCH = 2
STRIPES = (4, 20)          # first frames of the two forced time stripes
FIRST_SITE = ("audio_moe_p1_0", "audio_moe_p2_0")


def _cut(cfg):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=DEPTHS),
                               htsat=dataclasses.replace(cfg.htsat, depths=DEPTHS))


def _jax_gates(tree, path=()):
    """{'audio_moe_p1_0.multimodal_experts.gate': array} of the audio gates."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_gates(v, path + (k,)))
        elif k == "gate" and path[1].startswith("audio_moe_"):
            out[".".join(path[1:] + (k,))] = np.asarray(v).reshape(-1)
    return out


@pytest.fixture(scope="module")
def grads():
    import avmoe_tpu.audio.frontend as jfe
    from avmoe_tpu.config import tiny_ave_config as jax_tiny
    from avmoe_tpu.models.ave import AVEModel as JAVE

    import avmoe_tpu_torch.audio.frontend as pfe
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.convert import export_jax_variables
    from avmoe_tpu_torch.data.ave import SyntheticAVEDataset
    from avmoe_tpu_torch.data.loader import BatchLoader
    from avmoe_tpu_torch.models.ave import AVEModel

    cfg = _cut(tiny_ave_config())
    ds = SyntheticAVEDataset(length=8 * BATCH, num_segments=cfg.num_segments,
                             audio_len=cfg.audio_len, img_size=cfg.swin.img_size,
                             num_classes=cfg.num_classes)
    batch = next(iter(BatchLoader(ds, BATCH, shuffle=True, seed=999, device="cpu",
                                  num_workers=1)))
    wave, images = batch["wave"].numpy(), batch["images"].numpy()
    readout = np.random.RandomState(0).randn(
        BATCH, cfg.num_segments, cfg.num_classes).astype(np.float32)
    pm = AVEModel(cfg, device="cpu", seed=999)
    variables = to_jax(export_jax_variables(pm))
    jm = JAVE(_cut(jax_tiny()))
    width = cfg.htsat.frontend.time_drop_width - 1
    held = {}
    j_fold, p_fold = jfe.reshape_wav2img, pfe.reshape_wav2img

    def loss(params, keep):
        held["jax"] = keep
        out = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       jnp.asarray(wave), jnp.asarray(images), train=True,
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "specaug": jax.random.PRNGKey(2)},
                       mutable=["batch_stats", "telemetry", "intermediates"])[0]
        return (out["event_logits"] * readout).sum()

    j_grad = jax.jit(jax.grad(loss))
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVMOE_DETERMINISTIC_TRAIN", "1")
        mp.delenv("AVMOE_FUSED_MOE_TRAIN", raising=False)
        # the stripes zero whole time frames of the bn0-normalized log-mel,
        # where SpecAugment zeroes them, before the fold into an image
        mp.setattr(jfe, "reshape_wav2img",
                   lambda s, *a: j_fold(s * held["jax"][None, :, None], *a))
        mp.setattr(pfe, "reshape_wav2img",
                   lambda s, *a: p_fold(s * held["port"][None, :, None], *a))
        frames = 1 + cfg.audio_len // cfg.htsat.frontend.hop_length
        for stripes in (False, True):
            keep = np.ones(frames, np.float32)
            if stripes:
                for s in STRIPES:
                    keep[s:s + width] = 0.0
            held["port"] = torch.from_numpy(keep)
            tokens = []
            hook = pm.encoder.htsat.patch_embed.register_forward_hook(
                lambda mod, args, out: tokens.append(out.detach()))
            pm.zero_grad()
            out = pm(batch["wave"], batch["images"], train=True,
                     generator=torch.Generator().manual_seed(0))
            (out["event_logits"] * torch.from_numpy(readout)).sum().backward()
            hook.remove()
            flat = tokens[0].reshape(-1, tokens[0].shape[-1])
            res[stripes] = dict(
                zero_var=float((flat.var(dim=-1) == 0).float().mean()),
                port={n[len("encoder."):]: q.grad.numpy().reshape(-1).copy()
                      for n, q in pm.named_parameters()
                      if n.endswith(".gate") and ".audio_moe_" in n},
                jax=_jax_gates(jax.device_get(j_grad(variables["params"], jnp.asarray(keep)))))
    return res


def test_stripes_blow_up_the_first_audio_gates_in_both_packages(grads):
    off, on = grads[False], grads[True]
    assert off["zero_var"] == 0.0 and on["zero_var"] >= 0.2
    for adapter in FIRST_SITE:
        for experts in ("multimodal_experts", "singlemodal_experts"):
            name = f"{adapter}.{experts}.gate"
            base = np.abs(off["jax"][name]).max()
            blown = np.abs(on["jax"][name]).max()
            assert base < 1e2 and blown > 1e6 * base, (name, base, blown)


@pytest.mark.parametrize("stripes", [False, True], ids=["no_stripes", "stripes"])
def test_audio_gate_gradients_match_jax(grads, stripes):
    port, ref = grads[stripes]["port"], grads[stripes]["jax"]
    assert port.keys() == ref.keys() and len(ref) >= 2 * len(FIRST_SITE)
    for name, g in ref.items():
        np.testing.assert_allclose(port[name], g, rtol=2e-3, atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)
