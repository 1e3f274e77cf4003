"""Port fused MRF stage vs the JAX Pallas kernel (interpret mode) on CPU.

On a CPU tensor the port's ``fused_tail_stage`` is its plain version; the
CUDA kernel is held against that plain version in ``test_torch_cuda.py``
and by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.ops.pallas import resblock_tail as jtail
from hifigan_tpu_torch.ops import resblock_tail as ttail
from tests.torch_port_helpers import folded_pair, small_config


@pytest.mark.parametrize("resblock,stage,post", [("1", 0, False), ("1", 1, True), ("2", 1, True)])
def test_fused_tail_stage_matches_pallas(resblock, stage, post):
    h = small_config(resblock)
    fp, sd = folded_pair(h)
    ch = h["upsample_initial_channel"] // (2 ** (stage + 1))
    x = (np.random.default_rng(0).standard_normal((2, 200, ch)) * 0.3).astype(np.float32)

    jpack = jtail.pack_generator_tail(h, fp, stage, block=1)
    jpost = jtail.prepare_post(fp["conv_post"], 1) if post else None
    ref = np.asarray(jtail.fused_tail_stage(jnp.asarray(x), jpack, interpret=True,
                                            tile_blocks=64, post_pack=jpost))

    tpack = ttail.pack_generator_tail(h, sd, stage)
    tpost = ttail.prepare_post(sd) if post else None
    got = ttail.fused_tail_stage(torch.from_numpy(x), tpack, post_pack=tpost).numpy()
    assert got.shape == ref.shape == ((2, 200, 1) if post else (2, 200, ch))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_pack_layout_and_halo():
    h = small_config("1")
    _, sd = folded_pair(h)
    packed = ttail.pack_generator_tail(h, sd, 0)
    c = h["upsample_initial_channel"] // 2
    # ResBlock1 k3 d(1,3) and k5 d(1,3): chains of radii 1+1+3+1 and 2+2+6+2
    assert packed["halo"] == 12 and packed["pair_size"] == 2 and packed["convs_per_rb"] == 4
    assert [(k, d) for k, d, _ in packed["convs"]] == [(3, 1), (3, 1), (3, 3), (3, 1),
                                                        (5, 1), (5, 1), (5, 3), (5, 1)]
    k, _, off = packed["convs"][5]
    w = sd["resblocks.1.convs2.0.weight"]  # (O, I, K)
    kio = packed["w"][off:off + k * c * c].view(k, c, c)
    torch.testing.assert_close(kio, w.permute(2, 1, 0), rtol=0, atol=0)
    assert packed["desc"].tolist()[15:18] == [5, 1, off]


def test_auto_tile():
    # V1 stages of a 256-frame request at B=1: 2048, 16384, 32768, 65536 samples
    assert [ttail.auto_tile(1, t) for t in (2048, 16384, 32768, 65536)] == [32, 128, 256, 256]
    assert [ttail.auto_tile(16, t) for t in (2048, 16384)] == [256, 256]
