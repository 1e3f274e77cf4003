from hifigan_tpu_torch.callbacks.base import Callback, TrainLoop  # noqa: F401
from hifigan_tpu_torch.callbacks.checkpoints import (  # noqa: F401
    BestCheckpointCallback,
    ContinuousCheckpointCallback,
    HistoryCheckpointCallback,
)
from hifigan_tpu_torch.callbacks.logging import (  # noqa: F401
    OutputLoggingCallback,
    OutputSumCallback,
    OutputSumResetCallback,
    rank,
)
from hifigan_tpu_torch.callbacks.visualization import (  # noqa: F401
    ConfusionLoggingCallback,
    ModelGraphVisualizationCallback,
    ValidationClassificationCallback,
    ValidationVisualizationCallback,
)
