"""Generator checkpoints: weights carried from JAX, torch g_* files."""

import os

import numpy as np
import pytest
import torch

from hifigan_tpu.models import fold_weight_norm as jax_fold
from hifigan_tpu.train.checkpoint import export_torch_generator
from hifigan_tpu_torch.train.checkpoint import (
    generator_state_dict_from_jax,
    load_checkpoint,
    scan_checkpoint,
)
from tests.torch_port_helpers import jax_params, small_config


@pytest.mark.parametrize("resblock,folded", [("1", False), ("2", True)])
def test_state_dict_from_jax_agrees_with_export(resblock, folded):
    params = jax_params(small_config(resblock))
    if folded:
        params = jax_fold(params)
    ours = generator_state_dict_from_jax({"params": params})
    theirs = export_torch_generator(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k], np.float32))


def test_g_file_round_trip_and_scan(tmp_path):
    sd = generator_state_dict_from_jax(jax_params(small_config("1")))
    for step in (5, 120):
        torch.save({"generator": sd}, tmp_path / f"g_{step:08d}")
    latest = scan_checkpoint(str(tmp_path), "g_")
    assert os.path.basename(latest) == "g_00000120"
    assert scan_checkpoint(str(tmp_path), "do_") is None
    loaded = load_checkpoint(latest)["generator"]
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    (tmp_path / "native").write_bytes(b"\x80msgpack")
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "native"))
