"""The CUDA kernel against its plain version, on the card.

Imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips on a machine without a CUDA device.
"""

import pytest
import torch

from hifigan_tpu_torch.config import AttrDict, get_config
from hifigan_tpu_torch.models import Generator, fold_weight_norm
from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
from hifigan_tpu_torch.ops import resblock_tail as ttail

requires_cuda = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")


def _config(resblock: str, ch0: int) -> AttrDict:
    h = get_config("v1" if resblock == "1" else "v3")
    h.update(upsample_rates=[2, 2, 2], upsample_kernel_sizes=[4, 4, 4],
             upsample_initial_channel=ch0)
    return h


def _state(h) -> dict:
    gen = Generator(h, generator=torch.Generator().manual_seed(0))
    return fold_weight_norm(gen.state_dict())


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@requires_cuda
@pytest.mark.parametrize("resblock,stage,post,seq,tile", [
    ("1", 0, False, 1000, None),   # C=128: 64-wide column tiles
    ("1", 2, True, 777, 64),       # C=32: 32-wide column tiles, post folded, ragged last tile
    ("2", 2, True, 300, 32),       # ResBlock2 chain, C=32, post folded
])
def test_kernel_matches_plain_fp32(no_tf32, resblock, stage, post, seq, tile):
    h = _config(resblock, 256)
    sd = _state(h)
    ch = 256 // (2 ** (stage + 1))
    packed = ttail.pack_generator_tail(h, sd, stage, device="cuda")
    post_pack = ttail.prepare_post(sd, device="cuda") if post else None
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, seq, ch), device="cuda", generator=g) * 0.3
    launches = ttail.LAUNCHES
    got = ttail.fused_tail_stage(x, packed, post_pack=post_pack, tile=tile)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == launches + 1
    ref = ttail.fused_tail_stage_reference(x, packed, post_pack)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got - ref).abs().max().item() <= 1e-4


@requires_cuda
def test_fast_vocoder_launches_kernel_per_stage(no_tf32):
    h = _config("1", 128)
    sd = _state(h)
    mel = torch.randn((2, 80, 20), generator=torch.Generator().manual_seed(2)) * 2 - 5
    fast = make_fast_vocoder(h, sd, dtype=torch.float32)
    launches = ttail.LAUNCHES
    got = fast(mel)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == launches + len(h["upsample_rates"])
    gen = Generator(h, folded=True)
    gen.load_state_dict(sd)
    with torch.no_grad():
        ref = gen(mel)
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert (got.cpu() - ref).abs().max().item() <= 2e-4


@requires_cuda
def test_wrapper_rejects_bad_inputs():
    h = _config("1", 128)
    packed = ttail.pack_generator_tail(h, _state(h), 1, device="cuda")
    x = torch.zeros((1, 64, 32), device="cuda")
    with pytest.raises(ValueError):
        ttail.fused_tail_stage(x[:, :, :16], packed)  # wrong width
    with pytest.raises(ValueError):
        ttail.fused_tail_stage(x[:, ::2], packed)  # not contiguous
    with pytest.raises(ValueError):
        ttail.fused_tail_stage(x.bfloat16(), packed)  # weights in another dtype
