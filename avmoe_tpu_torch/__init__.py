"""avmoe_tpu_torch: the PyTorch/CUDA port of AVMoE, for an NVIDIA H100.

The package mirrors the layout of the JAX package `avmoe_tpu` module by
module. It covers the four tasks' models, each with its eval forward and
train step: AVE (`models/ave.py`: temporal attention or ReLU Linear heads
into CMBS, optionally with its interaction blocks, or the classification
path), AVVP (`models/avvp.py`, the MGN grouping heads), AVQA
(`models/avqa.py`, the LSTM question encoder, audio-guided grounding,
question-as-query attention and the frozen Swin pass over negative frames)
and AVS (`models/avs.py`, S4 and MS3 segmentation: the stage tokens through
TPAVI and an FPN decoder; S4's step trains HTS-AT). Under them: the log-mel
front end, the HTS-AT and Swin-V2 backbones in lock-step with MoE adapters,
the losses, metrics, freezing, the optimizer and the train step. Window
attention, the Swin MLP sub-block (forward and backward) and chains of Swin
blocks run as hand-written CUDA kernels (`csrc/`) on the card; on CPU
tensors the same wrappers take their plain PyTorch versions. Each task's
driver sits on top: the readers and the prefetching loader (`data/`),
torch checkpoints with resume (`checkpoint/`), expert telemetry and writers
(`telemetry/`), the epoch loop (`train/loop.py`) and the command lines
`python -m avmoe_tpu_torch.cli.train_{ave,avvp,avqa,avs}` (AVQA's with its
grounding stage, `models/avqa_grounding.py`). Beside them, the original
AVSBench model (`models/avs_baseline.py`: a PVT-v2 or ResNet-50 encoder,
ASPP, TPAVI and the FPN decoder, fed by the VGGish embeddings of
`backbones/vggish.py`), the legacy backbones, the attention zoo and the
loss library of the reference's surface. The adapters' expert mixture can
be contracted at bottleneck rank (`moe/adapter.py`, the fused combine);
`parallel/` runs the drivers data-parallel over torch.distributed, one
process a card; `utils/` has t-SNE, the figures and a profiler scope.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raise if CUDA is asked for and absent.

    The port never falls back from the card to the CPU on its own: a caller
    that wants the CPU asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
