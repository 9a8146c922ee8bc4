"""bf16 against float32 trainable gradients, in the JAX package and in the
port, on the CPU at the tiny config.

    python tools/jax_bf16_grad_cosine.py

One deterministic step (AVMOE_DETERMINISTIC_TRAIN=1, mixup λ given) of the
tiny AVE model with noised variables (non-zero adapter gates, from
`tests/torch_port_harness.py`), on the first batch of
`tests/test_torch_train_curve.py`. Prints the cosine of the trainable
gradients, overall and by parameter group, of: JAX bf16 against JAX
float32, the port's bf16 against its float32 (plain versions on the CPU),
and the port's float32 against JAX's. Shows whether a bf16 gradient that
leaves float32's is the port's doing or the model's arithmetic.
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

from torch_port_harness import jax_variables, to_jax  # noqa: E402
import test_torch_train_curve as curve  # noqa: E402
from avmoe_tpu.config import tiny_ave_config as jax_tiny  # noqa: E402
from avmoe_tpu.losses.ave import ave_loss as jax_ave_loss  # noqa: E402
from avmoe_tpu.models.ave import AVEModel as JAVE  # noqa: E402
from avmoe_tpu.train.freeze import merge_params, partition_params  # noqa: E402
from avmoe_tpu_torch.config import tiny_ave_config  # noqa: E402
from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables  # noqa: E402
from avmoe_tpu_torch.losses.ave import ave_loss  # noqa: E402
from avmoe_tpu_torch.models.ave import AVEModel  # noqa: E402
from avmoe_tpu_torch.train.freeze import freeze  # noqa: E402


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float64).ravel()
    return out


def cosines(a, b) -> str:
    groups = {}
    for k in b:
        groups.setdefault(k[1].rsplit("_", 1)[0] if k[0] == "encoder" else k[0], []).append(k)
    def cos(keys):
        u = np.concatenate([a[k] for k in keys])
        v = np.concatenate([b[k] for k in keys])
        return float(np.dot(u, v) / np.linalg.norm(u) / np.linalg.norm(v))

    return ", ".join([f"all {cos(list(b)):.6f}"] + [f"{g} {cos(ks):.4f}"
                                                     for g, ks in groups.items()])


def main():
    cfg = jax_tiny()
    b = curve._batches(cfg)[0]
    variables = jax_variables(JAVE(cfg), jnp.asarray(b["wave"]), jnp.asarray(b["images"]),
                              seed=3)
    trainable, frozen = partition_params(to_jax(variables)["params"])
    stats = to_jax(variables)["batch_stats"]

    def jax_grads(dtype):
        model = JAVE(cfg, dtype=dtype)

        def loss(t):
            out, _ = model.apply({"params": merge_params(t, frozen), "batch_stats": stats},
                                 jnp.asarray(b["wave"]), jnp.asarray(b["images"]), train=True,
                                 mixup_lambda=jnp.asarray(b["mixup_lambda"]),
                                 mutable=["batch_stats"])
            return jax_ave_loss(out, jnp.asarray(b["labels"]))[0]

        return flat(jax.jit(jax.grad(loss))(trainable))

    def port_grads(dtype):
        model = AVEModel(tiny_ave_config(), dtype=dtype, device="cpu", seed=None)
        load_jax_variables(model, variables)
        freeze(model)
        params = [p for p in model.parameters() if p.requires_grad]
        out = model(torch.from_numpy(b["wave"]), torch.from_numpy(b["images"]), train=True,
                    mixup_lambda=torch.from_numpy(b["mixup_lambda"]),
                    generator=torch.Generator())
        grads = torch.autograd.grad(ave_loss(out, torch.from_numpy(b["labels"]))[0], params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(g.float())
        return flat(export_jax_variables(model, trainable_only=True)["params"])

    j32, j16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    print(f"JAX bf16 / JAX f32: {cosines(j16, j32)}", flush=True)
    p32, p16 = port_grads(torch.float32), port_grads(torch.bfloat16)
    print(f"port bf16 / port f32: {cosines(p16, p32)}", flush=True)
    print(f"port f32 / JAX f32: {cosines(p32, j32)}", flush=True)


if __name__ == "__main__":
    main()
