from hifigan_tpu_torch.ops.conv import (  # noqa: F401
    LRELU_SLOPE,
    conv1d,
    conv_transpose1d,
    leaky_relu,
    weight_norm_kernel,
)
from hifigan_tpu_torch.ops.logmel import fused_log_mel, supports_fused_log_mel  # noqa: F401
from hifigan_tpu_torch.ops.msd_conv import msd_conv1d_lrelu  # noqa: F401
