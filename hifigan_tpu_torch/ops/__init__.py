from hifigan_tpu_torch.ops.conv import (  # noqa: F401
    LRELU_SLOPE,
    conv1d,
    conv_transpose1d,
    leaky_relu,
    weight_norm_kernel,
)
