from hifigan_tpu_torch.models.discriminators import (  # noqa: F401
    DiscriminatorP,
    DiscriminatorS,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from hifigan_tpu_torch.models.generator import Generator, ResBlock1, ResBlock2  # noqa: F401
from hifigan_tpu_torch.models.layers import fold_weight_norm  # noqa: F401
