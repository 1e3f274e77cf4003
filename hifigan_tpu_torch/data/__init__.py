from hifigan_tpu_torch.data.meldataset import (  # noqa: F401
    MelDataset,
    get_dataset_filelist,
    mel_spectrogram_np,
)
