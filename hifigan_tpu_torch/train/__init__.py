from hifigan_tpu_torch.train.checkpoint import (  # noqa: F401
    generator_state_dict_from_jax,
    load_checkpoint,
    save_checkpoint,
    scan_checkpoint,
    wait_for_checkpoints,
)
