"""The frozen cost copies equal ``chip_smoke.py``'s originals at V1's shapes."""

import importlib.util
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.costs import kernels as K
from port_bench.costs.model_flops import generator_flops, train_step_flops

ROOT = Path(__file__).resolve().parents[2]
H = harness.config("hifigan_v1")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_peaks_and_passes(smoke):
    assert (K.H100_BF16_FLOPS, K.H100_FP32_FLOPS, K.H100_BYTES_PER_S, K.H100_TF32_FLOPS,
            K.FP32_MMA_FLOPS) == (smoke.H100_BF16_FLOPS, smoke.H100_FP32_FLOPS,
                                  smoke.H100_BYTES_PER_S, smoke.H100_TF32_FLOPS,
                                  smoke.FP32_MMA_FLOPS)
    assert K.PASSES_PER_STEP == smoke.PASSES_PER_STEP
    assert all(K.msd_passes(layer) == smoke.msd_passes(layer) for layer in range(8))
    assert K.bound_ms(1e12, 1e9, 1e15) == smoke.bound_ms(1e12, 1e9, 1e15)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stage_cost_at_v1_stages(smoke, dtype):
    from hifigan_tpu_torch.ops import resblock_tail
    from port_bench.inputs import conv_weights
    from port_bench.reference.generator import conv_shapes

    params, _ = conv_weights(conv_shapes(H), torch.Generator().manual_seed(0),
                             torch.device("cpu"), fold=True)
    esize = torch.empty((), dtype=dtype).element_size()
    for i, packed in enumerate(K.stage_packs(H)):
        port = resblock_tail.pack_generator_tail(H, params, i, dtype=dtype)
        seq = 256 * 8 * 2 ** i
        for post in (False, True):
            assert K.stage_cost(packed, 1, seq, esize, post) == smoke.stage_cost(
                port, 1, seq, esize, post)


def test_stack_costs_at_v1_msd_scales(smoke):
    from hifigan_tpu_torch.models import MultiScaleDiscriminator

    msd = MultiScaleDiscriminator(generator=torch.Generator().manual_seed(0))
    for d, t in zip(msd.discriminators, K.msd_scale_lengths(8192)):
        specs, _, _ = smoke.stack_of(d, torch.float32)
        x = torch.empty((16, t, 128), device="meta")
        mine = K.msd_stack_specs(128)
        assert [tuple(s)[:7] for s in mine] == [(s.c_out, s.kernel, s.stride, s.groups, s.pad_l,
                                                 s.pad_r, s.slope) for s in specs]
        assert K.stack_cost(mine, x) == smoke.stack_cost(specs, x)
        assert K._layer_flops(mine, x) == smoke._layer_flops(specs, x)
    x, y = torch.empty((16, 8192, 128), device="meta"), torch.empty((16, 4096, 128), device="meta")
    assert K.conv_cost(x, 41, 32, y) == smoke.conv_cost(x, 41, 32, y)


def test_bounds_at_the_published_shapes():
    # PERF.md's kernel table: B1 0.154 ms a B=1 256-frame request (bf16); B2 3.028 + 2.271
    # + 1.514 ms a V1 step at 16 x 8192
    assert K.b1_bound_ms(H, 1, 256, torch.bfloat16, True) == pytest.approx(0.154, abs=5e-4)
    assert K.b2_step_bound_ms(H, 16, 8192) == pytest.approx(6.813, abs=2e-3)


def test_model_flops_are_linear_in_frames_and_count_backward():
    assert generator_flops(H, 96) == 96 * generator_flops(H, 1)
    per_sample = generator_flops(H, 256) / (256 * H["hop_size"])
    assert per_sample == pytest.approx(2.40e6, rel=0.01)
    tiny = dict(H, upsample_initial_channel=32, mpd_channels=[4, 8, 16, 32], msd_width=16)
    step = train_step_flops(tiny, 2, 8192)
    assert step > 3 * generator_flops(tiny, 32, 2)
