"""hifigan_tpu_torch — the PyTorch / CUDA port of hifigan_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout so each module's counterpart is easy to
find; the JAX package stays the reference the port is tested against.

- ``hifigan_tpu_torch.audio``  — wav I/O, STFT, log-mel pipeline
- ``hifigan_tpu_torch.data``   — the vocoder training dataset
- ``hifigan_tpu_torch.models`` — Generator V1/V2/V3, MPD/MSD discriminators,
  losses, normed conv layers, the low-latency fused-stage vocoder
- ``hifigan_tpu_torch.ops``    — conv primitives and the CUDA kernels' wrappers
  (``fused_tail_stage``, ``fused_conv_stack``, ``fused_stream_graph``,
  ``msd_conv1d_lrelu``, ``fused_log_mel``)
- ``hifigan_tpu_torch.train``  — the GAN trainer, ``g_*``/``do_*`` checkpoints,
  the distillation weight carrier
- ``hifigan_tpu_torch.dsl``    — the model-builder DSL and its interpreter
- ``hifigan_tpu_torch.distill`` — the speech-distillation models and train step
- ``hifigan_tpu_torch.cli``    — inference and training CLIs

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from hifigan_tpu_torch.config import AttrDict, load_config  # noqa: F401
from hifigan_tpu_torch.train.checkpoint import load_checkpoint, scan_checkpoint  # noqa: F401
