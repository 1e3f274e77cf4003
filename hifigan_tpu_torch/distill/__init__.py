"""Speech distillation (PyTorch port of ``hifigan_tpu/distill``): the
GAN-autoencoder models and their train step."""

from hifigan_tpu_torch.distill.cycles import calculate_cycles, cycles_valid  # noqa: F401
from hifigan_tpu_torch.distill.losses import (  # noqa: F401
    get_loss_by_type,
    get_losses_by_types,
    recursive_loss,
)
from hifigan_tpu_torch.distill.tensor_ops import cut_and_roll, expand, mix, unmix  # noqa: F401
