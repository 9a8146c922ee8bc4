"""How well conditioned the LAVisH model's trainable gradient is, in the JAX
package and in the port, on the CPU at the tiny config.

    python tools/lavish_grad_conditioning.py

`MMILNetV2(replace(tiny_ave_config(), d_model=32))`, one loss evaluation
(`make_mmil_v2_loss_fn`, AVMOE_DETERMINISTIC_TRAIN=1) on a seeded batch of 4
clips, from two sets of weights: the port's seeded init (seed 0: adapter
gates and gate_av zero, as training starts) and the same with the gates,
gate_av and running statistics noised as `chip_smoke.py` `_nonzero_gates_`
noises them. For each it prints, over the live trainable leaves (rms
above 1e-6 of the largest leaf's in JAX float32):

  * JAX float32 against JAX float32 with the spectrogram images scaled by
    1 + 1e-6 seeded noise: the leaves whose gradient cosine is below 0.99
    (the gradient's own sensitivity to rounding-sized input changes);
  * the port's float32 against JAX's float32, the same way;
  * the largest |gradient| in bf16 over the largest in float32, in each
    package.

Imports JAX and the port, like the parity tests; a few minutes of CPU.
"""

from __future__ import annotations

import os
import sys

os.environ["AVMOE_DETERMINISTIC_TRAIN"] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from flax import traverse_util  # noqa: E402
from torch_port_harness import to_jax  # noqa: E402

import chip_smoke as cs  # noqa: E402
from avmoe_tpu.config import replace as jreplace, tiny_ave_config as jax_tiny  # noqa: E402
from avmoe_tpu.models.ave_legacy import MMILNetV2 as JV2  # noqa: E402
from avmoe_tpu.models.ave_legacy import make_mmil_v2_loss_fn as j_loss  # noqa: E402
from avmoe_tpu.train.freeze import merge_params, partition_params  # noqa: E402
from avmoe_tpu_torch.config import replace, tiny_ave_config  # noqa: E402
from avmoe_tpu_torch.convert import export_jax_variables  # noqa: E402
from avmoe_tpu_torch.models.ave_legacy import MMILNetV2, make_mmil_v2_loss_fn  # noqa: E402
from avmoe_tpu_torch.train.freeze import freeze  # noqa: E402


def _batch(cfg):
    g = torch.Generator().manual_seed(0)
    S = cfg.swin.img_size
    spec = (0.5 * torch.randn(4, cfg.num_segments, S, S, generator=g)).numpy()
    images = torch.rand(4, cfg.num_segments, S, S, 3, generator=g).numpy()
    labels = np.eye(cfg.num_classes + 1, dtype=np.float32)[
        np.random.RandomState(0).randint(0, cfg.num_classes + 1, (4, cfg.num_segments))]
    nudge = 1 + 1e-6 * np.random.RandomState(5).randn(*spec.shape).astype(np.float32)
    return {"audio_spec": spec, "images": images, "labels": labels}, nudge


def _jax_grad_fn(batch, dtype):
    """jit(grad) of the JAX loss wrt the trainable leaves, given (trainable,
    frozen, batch_stats, spectrogram images): one compile a dtype."""
    jm = JV2(jreplace(jax_tiny(), d_model=32), dtype=dtype)

    def loss(t, frozen, stats, spec):
        b = dict(batch, audio_spec=spec)
        return j_loss(jm)({"params": merge_params(t, frozen), "batch_stats": stats},
                          {k: jnp.asarray(v) for k, v in b.items()},
                          {"dropout": jax.random.PRNGKey(0)})[0]

    return jax.jit(jax.grad(loss))


def _flat(tree):
    return {"/".join(k): np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(tree).items()}


def _port_grads(model, batch, dtype):
    m = MMILNetV2(model.cfg, dtype=dtype, device="cpu", seed=None)
    m.load_state_dict(model.state_dict())
    freeze(m)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = make_mmil_v2_loss_fn(m)(m, tb, torch.Generator().manual_seed(0))
    named = [(n, p) for n, p in m.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    with torch.no_grad():
        for (_, p), g in zip(named, grads):
            p.copy_(g.float())
    return _flat(export_jax_variables(m, trainable_only=True)["params"])


def _live(ref):
    """The leaves whose rms is above 1e-6 of the largest leaf's (the others
    are behind zero gates or at rounding level)."""
    rms = {k: float(np.sqrt(np.mean(np.square(v)))) for k, v in ref.items()}
    top = max(rms.values())
    return [k for k, r in rms.items() if r > 1e-6 * top]


def _below(a, b, live) -> int:
    cos = lambda x, y: float(x.ravel() @ y.ravel() / (np.linalg.norm(x) * np.linalg.norm(y)
                                                      + 1e-30))
    return sum(cos(a[k], b[k]) < 0.99 for k in live)


def main():
    cfg = replace(tiny_ave_config(), d_model=32)
    batch, nudge = _batch(cfg)
    grad32, grad16 = _jax_grad_fn(batch, jnp.float32), _jax_grad_fn(batch, jnp.bfloat16)
    spec = jnp.asarray(batch["audio_spec"])
    for label, noised in (("seeded init (zero gates)", False), ("noised gates", True)):
        model = MMILNetV2(cfg, device="cpu", seed=0)
        if noised:
            cs._nonzero_gates_(model, 1)
        variables = to_jax(export_jax_variables(model))
        trainable, frozen = partition_params(variables["params"])
        args = (trainable, frozen, variables["batch_stats"])
        j32 = _flat(grad32(*args, spec))
        j32n = _flat(grad32(*args, spec * jnp.asarray(nudge)))
        j16 = _flat(grad16(*args, spec))
        p32 = _port_grads(model, batch, torch.float32)
        p16 = _port_grads(model, batch, torch.bfloat16)
        live = _live(j32)
        top = lambda d: max(float(np.abs(v).max()) for v in d.values())
        print(f"[{label}] {len(live)} of {len(j32)} trainable leaves live; cosine < 0.99: JAX "
              f"f32 vs JAX f32 nudged 1e-6 {_below(j32n, j32, live)}, port f32 vs JAX f32 "
              f"{_below(p32, j32, live)}; "
              f"largest |grad| bf16 / f32: JAX {top(j16):.4g} / {top(j32):.4g} = "
              f"{top(j16) / top(j32):.3g}, port {top(p16):.4g} / {top(p32):.4g} = "
              f"{top(p16) / top(p32):.3g}")


if __name__ == "__main__":
    main()
