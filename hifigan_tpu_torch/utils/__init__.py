from hifigan_tpu_torch.utils.pytree import detach_recursively, do_recursive, get_recursive  # noqa: F401
