from hifigan_tpu_torch.audio.mel import (  # noqa: F401
    MAX_WAV_VALUE,
    MelConfig,
    dynamic_range_compression,
    dynamic_range_decompression,
    log_mel_spectrogram,
    mel_filterbank,
    mel_spectrogram,
)
from hifigan_tpu_torch.audio.stft import frame_signal, hann_window, stft_magnitude  # noqa: F401
from hifigan_tpu_torch.audio.io import load_wav, save_wav  # noqa: F401
