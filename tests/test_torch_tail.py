"""Port fused MRF stage vs the JAX Pallas kernel (interpret mode) on CPU.

On a CPU tensor the port's ``fused_tail_stage`` is its plain version; the
CUDA kernel is held against that plain version in ``test_torch_cuda.py``
and by ``chip_smoke.py`` on the card. Both bodies' schedules (bf16 tensor
cores; fp32 3xTF32 on the conv core's tiles) and their host plans are
emulated here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hifigan_tpu.ops.pallas import resblock_tail as jtail
from hifigan_tpu_torch import config as tconfig
from hifigan_tpu_torch.ops import conv_stack as cs
from hifigan_tpu_torch.ops import resblock_tail as ttail
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, leaky_relu
from tests.torch_port_helpers import fold_up_config, folded_pair, small_config


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


@pytest.mark.parametrize("resblock,post", [("1", True), ("2", False)])
def test_fused_tail_stage_with_pre_pack_matches_pallas(resblock, post):
    """The folded upsampler (lrelu -> ConvTranspose1d stride 2 -> MRF) on
    the previous stage's output, against the Pallas kernel with
    ``prepare_upsample`` at the JAX test's bound (tests/test_pallas_tail.py)."""
    h = fold_up_config(resblock)
    fp, sd = folded_pair(h)
    u, k = h["upsample_rates"][1], h["upsample_kernel_sizes"][1]
    x = (np.random.default_rng(5).standard_normal((2, 96, 16)) * 0.3).astype(np.float32)
    jpre = jtail.prepare_upsample(fp["ups_1"], u, (k - u) // 2, 16)
    jpost = jtail.prepare_post(fp["conv_post"], 16) if post else None
    ref = np.asarray(jtail.fused_tail_stage(jnp.asarray(x), jtail.pack_generator_tail(h, fp, 1, 16),
                                            interpret=True, tile_blocks=4, post_pack=jpost,
                                            pre_pack=jpre))
    pre = ttail.prepare_upsample(sd, 1, u, (k - u) // 2)
    got = ttail.fused_tail_stage(torch.from_numpy(x), ttail.pack_generator_tail(h, sd, 1),
                                 post_pack=ttail.prepare_post(sd) if post else None,
                                 pre_pack=pre).numpy()
    assert got.shape == ref.shape == ((2, 192, 1) if post else (2, 192, 8))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k,stride", [(4, 2), (16, 8), (11, 5), (8, 4), (5, 2)])
def test_prepare_upsample_phase_split_is_the_transposed_conv(k, stride):
    """Output row m * stride + p of the transposed conv is the phase-p conv
    of ``taps`` input rows from m + pre_offset; a tap past k is zero. Odd
    k - stride has no T_in * stride output and is refused."""
    g = torch.Generator().manual_seed(k)
    c_in, c_out, t_in = 6, 4, 13
    pad = (k - stride) // 2
    sd = {"ups.0.weight": torch.randn((c_in, c_out, k), generator=g),
          "ups.0.bias": torch.randn((c_out,), generator=g)}
    if k - 2 * pad != stride:
        with pytest.raises(ValueError, match="k - 2 \\* padding"):
            ttail.prepare_upsample(sd, 0, stride, pad)
        return
    pre = ttail.prepare_upsample(sd, 0, stride, pad, dtype=torch.float64)
    assert pre["taps"] == -(-k // stride) and pre["c_in"] == c_in and pre["channels"] == c_out
    x = torch.randn((1, t_in, c_in), generator=g, dtype=torch.float64)
    want = F.conv_transpose1d(x.transpose(1, 2), sd["ups.0.weight"].double(),
                              sd["ups.0.bias"].double(), stride=stride, padding=pad)
    w = pre["w"].view(stride, pre["taps"], c_in, c_out)
    got = torch.empty_like(want)
    for p in range(stride):
        off = ttail.pre_offset(pre, p)
        xp = F.pad(x.transpose(1, 2), (max(0, -off), pre["taps"] + max(0, off)))
        ph = F.conv1d(xp, w[p].permute(2, 1, 0), pre["bias"])
        got[:, :, p::stride] = ph[:, :, off + max(0, -off):][:, :, :t_in]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_pack_layout_and_halo():
    h = small_config("1")
    _, sd = folded_pair(h)
    packed = ttail.pack_generator_tail(h, sd, 0)
    c = h["upsample_initial_channel"] // 2
    # ResBlock1 k3 d(1,3) and k5 d(1,3): chains of radii 1+1+3+1 and 2+2+6+2
    radii = [sum((k - 1) * d // 2 for k, d, _ in packed["convs"][i:i + 4]) for i in (0, 4)]
    assert radii == [6, 12] and packed["pair_size"] == 2 and packed["convs_per_rb"] == 4
    assert [(k, d) for k, d, _ in packed["convs"]] == [(3, 1), (3, 1), (3, 3), (3, 1),
                                                        (5, 1), (5, 1), (5, 3), (5, 1)]
    k, _, off = packed["convs"][5]
    w = sd["resblocks.1.convs2.0.weight"]  # (O, I, K)
    kio = packed["w"][off:off + k * c * c].view(k, c, c)
    torch.testing.assert_close(kio, w.permute(2, 1, 0), rtol=0, atol=0)
    assert packed["desc"].tolist()[15:18] == [5, 1, off]


def _stage_meta(name: str, stage: int, c: int | None = None, weights=torch.empty) -> dict:
    """Stage ``stage`` of a shipped config (at width ``c`` if given) packed
    with ``weights(c, c, k)`` (default uninitialised: the plan reads only
    the widths, taps and dilations) and zero biases."""
    h = tconfig.get_config(name)
    c = c or h["upsample_initial_channel"] // 2 ** (stage + 1)
    is_rb1 = str(h["resblock"]) == "1"
    convs = []
    for k, dils in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
        rb = []
        for d in dils:
            rb.append((weights(c, c, k), torch.zeros(c), d))
            if is_rb1:
                rb.append((weights(c, c, k), torch.zeros(c), 1))
        convs.append(rb)
    return ttail.prepare_tail_stage(convs, 2 if is_rb1 else 1)


def _two_per_sm(c, smem, f32_minb):
    return max(1, min(2, ttail.SMEM_LIMIT // smem))


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_plan_every_shipped_stage(name):
    """The host plan of every V1, V2 and V3 stage at B=1..16: bf16 takes the
    tensor-core body's cooperative schedule, its grid fits the co-resident
    blocks and the busiest phase, its shared memory fits 227 KB. Lengths of
    a 256-frame request, a ragged one and one shorter than a tile."""
    h = tconfig.get_config(name)
    t = 256
    for stage, u in enumerate(h["upsample_rates"]):
        t *= u
        packed = _stage_meta(name, stage)
        c = packed["channels"]
        post = stage == len(h["upsample_rates"]) - 1
        for batch in (1, 3, 16):
            for seq in (t, t - 7, 50):
                plan = ttail.plan_tail_stage(packed, batch, seq, torch.bfloat16, post, 132,
                                             _two_per_sm)
                items = packed["n_rb"] * batch * -(-seq // 128) * -(-c // ttail.tc_tiling(c)[0])
                assert plan["body"] == "tensor_core" and plan["schedule"] == "cooperative"
                assert plan["smem"] <= ttail.SMEM_LIMIT
                assert plan["items"] == items and plan["tile"] == 128
                assert plan["grid"] == min(items, _two_per_sm(c, plan["smem"], 0) * 132)
                assert plan["scratch"] == (2 * packed["n_rb"] + post) * batch * seq * c


def test_plan_tiling_and_shared_memory():
    """The tensor-core tiling per width (V2's C = 16 and 8 pad the input to
    16) and the shared memory of V1 stage 0: a (128 + 50)-row window of
    264-element rows and a 3-slot ring of 64 x 136 weights, in bytes."""
    assert [ttail.tc_tiling(c) for c in (256, 128, 64, 32, 16, 8, 40)] == [
        (128, 256, 64), (128, 128, 64), (64, 64, 64), (32, 32, 32), (32, 16, 16),
        (32, 16, 16), (64, 48, 16)]
    packed = _stage_meta("v1", 0)
    plan = ttail.plan_tail_stage(packed, 1, 2048, torch.bfloat16, False, 132,
                                 lambda c, s, dtype: 1)
    assert plan["smem"] == (128 + 50) * 264 * 2 + 3 * 64 * 136 * 2 == 146208
    assert plan["items"] == 3 * 16 * 2 and plan["grid"] == 96  # every resblock's tiles at once
    with pytest.raises(ValueError, match="multiples of 8"):
        ttail.plan_tail_stage(dict(packed, channels=12), 1, 64, torch.bfloat16, False, 132,
                              _two_per_sm)
    with pytest.raises(ValueError, match="shared memory"):
        ttail.plan_tail_stage(dict(packed, channels=1024), 1, 64, torch.bfloat16, False, 132,
                              _two_per_sm)


def _upsample_emulation(x: torch.Tensor, pre: dict) -> torch.Tensor:
    """The tensor-core body's upsampling phase on the CPU: per output phase
    p and 128 input rows, the lrelu'd window of 128 + taps - 1 input rows
    from m0 + pre_offset(p) (zero outside [0, T_in)), the phase's taps with
    fp32 sums, the bias, one rounding, stored at rows m * stride + p."""
    dtype, (b, t_in, c_in) = x.dtype, x.shape
    u, taps, c = pre["stride"], pre["taps"], pre["channels"]
    w = pre["w"].view(u, taps, c_in, c)
    out = torch.full((b, t_in * u, c), float("nan"), dtype=dtype)
    for p in range(u):
        off = ttail.pre_offset(pre, p)
        for m0 in range(0, t_in, ttail.TC_BM):
            rows = torch.arange(m0 + off, m0 + ttail.TC_BM + taps - 1 + off)
            inside = (rows >= 0) & (rows < t_in)
            win = torch.zeros((b, rows.numel(), c_in), dtype=dtype)
            win[:, inside] = x[:, rows[inside]]
            acc = F.conv1d(leaky_relu(win, LRELU_SLOPE).transpose(1, 2).float(),
                           w[p].float().permute(2, 1, 0))
            v = (acc + pre["bias"].float()[:, None]).to(dtype).transpose(1, 2)[:, : t_in - m0]
            out[:, (m0 + torch.arange(v.shape[1])) * u + p] = v
    return out


@pytest.mark.parametrize("name,stage", [("v1", 2), ("v1", 3), ("v2", 2), ("v2", 3)])
def test_plan_with_a_folded_upsampler(name, stage):
    """With ``pre`` the bf16 body's window also holds 128 + taps - 1 rows of
    C_in = 2C (and the ring its chunks), the busiest phase may be the
    upsampling one (stride x input tiles), and one more plane holds the
    upsampled x; the fp32 body also sizes its upsampling tiles (C_in wide)
    and keeps the lrelu'd input."""
    h = tconfig.get_config(name)
    packed = _stage_meta(name, stage)
    c = packed["channels"]
    pre = {"c_in": 2 * c, "channels": c, "stride": 2, "taps": 2, "padding": 1}
    max_ext = max((k - 1) * d for k, d, _ in packed["convs"])
    bn, cpad, kc = ttail.tc_tiling(c)
    _, cpad_in, kc_in = ttail.tc_tiling(2 * c)
    window = max((128 + max_ext) * (cpad + 8), (128 + 1) * (cpad_in + 8))
    assert ttail.tc_smem(c, max_ext, pre) == (-(-window // 8) * 8 * 2
                                              + 3 * max(kc, kc_in) * (bn + 8) * 2)
    assert ttail.tc_smem(c, max_ext, pre) >= ttail.tc_smem(c, max_ext)
    post = stage == len(h["upsample_rates"]) - 1
    for batch, t_in in ((1, 256 * 64 << (stage - 2)), (3, 259)):  # a 256-frame request, ragged
        seq = 2 * t_in
        plan = ttail.plan_tail_stage(packed, batch, seq, torch.bfloat16, post, 132, _two_per_sm,
                                     pre=pre)
        items = max(packed["n_rb"] * batch * -(-seq // 128),
                    2 * batch * -(-t_in // 128)) * -(-c // bn)
        assert plan["items"] == items and plan["smem"] == ttail.tc_smem(c, max_ext, pre)
        assert plan["scratch"] == (2 * packed["n_rb"] + post + 1) * batch * seq * c
        f32 = ttail.plan_tail_stage(packed, batch, seq, torch.float32, post, 132, _two_per_sm,
                                    pre=pre)
        plane = -(-batch * seq * c // 4) * 4
        assert f32["scratch"] == (2 + 3 * packed["n_rb"] + post) * plane + batch * t_in * 2 * c
        up = cs.ConvShape(batch, t_in, 2 * c, t_in, c, 2)
        assert f32["kc_in"] == min(2 * c, 64)
        assert f32["smem"] == max(ttail.f32_smem(ttail.f32_convs(packed, batch, seq), f32["kc"]),
                                  cs.win_plan(up, False, torch.float32, 128, f32["bn"],
                                              f32["kc_in"])["smem"])
        assert f32["items"] == max(packed["n_rb"] * -(-batch * seq // 128),
                                   2 * -(-batch * t_in // 128)) * -(-c // f32["bn"])
    with pytest.raises(ValueError, match="pre_pack gives"):
        ttail.plan_tail_stage(packed, 1, 257, torch.bfloat16, False, 132, _two_per_sm, pre=pre)


def _cooperative_emulation(x: torch.Tensor, packed: dict, post_pack: dict | None,
                           pre_pack: dict | None = None) -> torch.Tensor:
    """The tensor-core body's schedule on the CPU, in the kernel's order:
    with ``pre_pack`` first the upsampling phase into the plane that then
    stands for x; phase j runs conv j of every resblock (widest first) in
    128-row tiles, each tile's operand the lrelu'd, masked window of 128 +
    (k-1)*d rows of its source; sources, residuals and outputs by the
    kernel's buffer codes (0 = x, 1 and 2 = the resblock's planes; a pair's
    last conv updates h in place); then the fp32 mean and the post conv."""
    if pre_pack is not None:
        x = _upsample_emulation(x, pre_pack)
    dtype, (b, t, c) = x.dtype, x.shape
    per, ps, n_rb = packed["convs_per_rb"], packed["pair_size"], packed["n_rb"]
    planes = [{0: x} for _ in range(n_rb)]
    h_code = prev_code = 0
    for j in range(per):
        first, last = j % ps == 0, j % ps == ps - 1
        src_code = h_code if first else prev_code
        dst_code = 2 if src_code == 1 else 1
        for rb in reversed(range(n_rb)):
            k, d, off = packed["convs"][rb * per + j]
            r = (k - 1) * d // 2
            kio = packed["w"][off:off + k * c * c].view(k, c, c)
            src, res = planes[rb][src_code], planes[rb][h_code]
            out = torch.empty_like(x) if dst_code not in planes[rb] else planes[rb][dst_code]
            for m0 in range(0, t, ttail.TC_BM):
                rows = torch.arange(m0 - r, m0 + ttail.TC_BM + r)
                inside = (rows >= 0) & (rows < t)
                win = torch.zeros((b, rows.numel(), c), dtype=dtype)
                win[:, inside] = src[:, rows[inside]]
                acc = F.conv1d(leaky_relu(win, LRELU_SLOPE).transpose(1, 2).float(),
                               kio.float().permute(2, 1, 0), dilation=d)
                v = (acc + packed["bias"][rb * per + j].float()[:, None]).to(dtype)
                v = v.transpose(1, 2)[:, : t - m0]
                if last:
                    v = (res[:, m0:m0 + v.shape[1]] + v).to(dtype)
                out[:, m0:m0 + v.shape[1]] = v
            planes[rb][dst_code] = out
        prev_code = dst_code
        if last:
            h_code = dst_code
    acc = None
    for rb in range(n_rb):
        acc = planes[rb][h_code].float() if acc is None else acc + planes[rb][h_code].float()
    mean = (acc / n_rb).to(dtype)
    if post_pack is None:
        return mean
    wav = F.conv1d(leaky_relu(mean.transpose(1, 2), 0.01).float(),
                   post_pack["w"].float().t()[None], post_pack["bias"].float(), padding=3)
    return torch.tanh(wav).transpose(1, 2).contiguous()


def _hold_emulation(resblock: str, stage: int, post: bool, seq: int, pre: bool) -> None:
    h = fold_up_config(resblock) if pre else small_config(resblock)
    _, sd = folded_pair(h)
    ch = h["upsample_initial_channel"] // (2 ** (stage + 1))
    u, k = h["upsample_rates"][stage], h["upsample_kernel_sizes"][stage]
    pre_pack = (ttail.prepare_upsample(sd, stage, u, (k - u) // 2, dtype=torch.bfloat16)
                if pre else None)
    x = np.random.default_rng(stage).standard_normal((2, seq, 2 * ch if pre else ch)) * 0.5
    x = torch.from_numpy(x).to(torch.bfloat16)
    packed = ttail.pack_generator_tail(h, sd, stage, dtype=torch.bfloat16)
    post_pack = ttail.prepare_post(sd, dtype=torch.bfloat16) if post else None
    want = ttail.fused_tail_stage_reference(x, packed, post_pack, pre_pack)
    got = _cooperative_emulation(x, packed, post_pack, pre_pack)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)


@pytest.mark.parametrize("resblock,stage,post,seq", [("1", 0, False, 300), ("1", 1, True, 259),
                                                     ("2", 1, True, 130)])
def test_cooperative_schedule_emulation_equals_the_plain_version(resblock, stage, post, seq):
    """The bf16 body's tiling, masks and buffer rotation (ResBlock1 pairs
    updating h in place, ResBlock2's single convs) give exactly the plain
    version's values, in bf16, ragged last tile included."""
    _hold_emulation(resblock, stage, post, seq, pre=False)


@pytest.mark.parametrize("resblock,post,t_in", [("1", True, 261), ("2", False, 130)])
def test_cooperative_schedule_with_the_pre_phase_equals_the_plain_version(resblock, post, t_in):
    """With a folded stride-2 upsampler the upsampling phase (per-phase
    128-row input tiles, strided stores, edge masks) runs first and its
    plane stands for x: still exactly the plain version's values, ragged
    last tile included."""
    _hold_emulation(resblock, 1, post, t_in, pre=True)


# ---------------------------------------------------------------------------
# The fp32 body: 3xTF32 on the conv core's tiles, the cooperative schedule
# ---------------------------------------------------------------------------

def _fp32_plan_cases(name: str):
    h = tconfig.get_config(name)
    t = 256
    for stage, u in enumerate(h["upsample_rates"]):
        t *= u
        yield stage, t, stage == len(h["upsample_rates"]) - 1


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_fp32_plan_every_shipped_stage(name):
    """The fp32 body's plan of every V1, V2 and V3 stage at B = 1, 3, 16:
    the cooperative schedule on 128-row tiles across batch rows, the column
    tile by width; the kernel compiled for two blocks an SM where the
    busiest phase has two tiles for each of the 132 SMs and a chunk fits
    half an SM's shared memory, else for one; the widest channel chunk that
    fits (every conv's chunk one the core takes), shared memory the most
    any conv tile needs (the conv core's window plan), the grid within the
    co-resident blocks and the busiest phase, the scratch planes."""
    two_block = ttail.SM_SMEM // 2 - 1024
    for stage, t, post in _fp32_plan_cases(name):
        packed = _stage_meta(name, stage)
        c = packed["channels"]
        bn = 16 if c <= 16 else 32 if c <= 32 else 64
        for batch in (1, 3, 16):
            for seq in (t, t - 7, 50):
                plan = ttail.plan_tail_stage(packed, batch, seq, torch.float32, post, 132,
                                             _two_per_sm)
                shapes = [cs.ConvShape(batch, seq, c, seq, c, k, 1, d, 1, (k - 1) * d // 2)
                          for k, d, _ in packed["convs"]]

                def smem(kc):
                    return max(cs.win_plan(g, False, torch.float32, 128, bn, kc)["smem"]
                               for g in shapes)

                def widest(limit):
                    return next((kc for kc in (min(c, 64), 32, 16, 8)
                                 if all(cs.kc_ok(g, False, torch.float32, kc) for g in shapes)
                                 and smem(kc) <= limit), None)

                items = packed["n_rb"] * -(-batch * seq // 128) * -(-c // bn)
                minb = 2 if items >= 264 and widest(two_block) else 1
                kc = widest(two_block if minb == 2 else ttail.SMEM_LIMIT)
                assert plan["body"] == "3xtf32" and plan["schedule"] == "cooperative"
                assert (plan["tile"], plan["bn"], plan["kc"], plan["minb"]) == (128, bn, kc, minb)
                assert plan["smem"] == smem(kc) <= ttail.SMEM_LIMIT
                assert plan["items"] == items
                assert plan["grid"] == min(items, _two_per_sm(c, plan["smem"], minb) * 132)
                assert plan["scratch"] == ((1 + 3 * packed["n_rb"] + post)
                                           * -(-batch * seq * c // 4) * 4)
                if name == "v1" and seq == t and batch == 1:
                    # stage 0's 192 tiles: one block an SM, 64-channel chunks; stage 1's 768:
                    # two, in 32-channel chunks (64 would need 124,864 bytes); stage 2's
                    # 64-channel window fits two blocks
                    assert (plan["minb"], plan["kc"]) == [(1, 64), (2, 32), (2, 64), (2, 32)][stage]
                if (name, stage, batch, seq) == ("v3", 0, 16, 50):
                    # 128-row tiles over 50-row batch rows: a window of 128 +
                    # 4 x 72 rows (V3's widest extent), too tall at 64 channels
                    assert plan["kc"] <= 32 and smem(64) > ttail.SMEM_LIMIT


@pytest.mark.parametrize("c,bn,kc", [(12, 16, 16), (40, 64, 40), (72, 64, 64)])
def test_fp32_plan_pads_a_width(c, bn, kc):
    """Widths that are not a multiple of 8 (or of the 64-channel chunk) are
    zero-padded to the chunk: 12 channels in one 16-channel chunk, 40 in
    one of 40, 72 in two of 64 (each spanning two ring stages or more); the
    bf16 body refuses 12."""
    packed = _stage_meta("v1", 0, c=c)
    plan = ttail.plan_tail_stage(packed, 2, 300, torch.float32, True, 132, _two_per_sm)
    assert (plan["bn"], plan["kc"]) == (bn, kc) and plan["smem"] <= ttail.SMEM_LIMIT
    g = cs.ConvShape(2, 300, c, 300, c, 11, 1, 5, 1, 25)
    wp = cs.win_plan(g, False, torch.float32, 128, bn, kc)
    assert wp["chunks"] == -(-c // kc) and wp["chunks"] * kc >= c
    assert plan["smem"] == ttail.f32_smem(ttail.f32_convs(packed, 2, 300), kc) == wp["smem"]
    if c % 8:
        with pytest.raises(ValueError, match="multiples of 8"):
            ttail.plan_tail_stage(packed, 2, 300, torch.bfloat16, True, 132, _two_per_sm)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _exact(a, b, stages):
    return (a.double() @ b.double()).float()


def _mma(terms):
    """The kernel's product of one tile's reduction: per ring stage (32
    reduction rows) a zeroed fp32 partial takes each k8 step's terms in the
    kernel's order (each term's 8 products exact, rounded once as they join
    the partial); the partials join the accumulator with IEEE adds."""
    def product(a, b, stages):
        a, b = a.float(), b.float()
        ah, bh = _tf32(a), _tf32(b)
        parts = {"hi": (ah, bh), "lo": (_tf32(a - ah), _tf32(b - bh))}
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for k0, k1 in stages:
            part = torch.zeros_like(acc)
            for k in range(k0, k1, 8):
                for pa, pb in terms:
                    pa, pb = parts[pa][0], parts[pb][1]
                    part = part + (pa[:, k:k + 8].double() @ pb[k:k + 8].double()).float()
            acc = acc + part
        return acc
    return product


THREE_TF32 = _mma([("lo", "hi"), ("hi", "lo"), ("hi", "hi")])
ONE_TF32 = _mma([("hi", "hi")])


def _f32_conv(src, kio, d, shift, kc, bn, product):
    """One conv tile pass of the fp32 body over an activated plane src (B,
    T, C_in) with taps kio (k, C_in, C_out): tap q of output row t reads
    source row t + q*d + shift (zero outside [0, T)). Rows are 128-row tiles
    of the B*T rows; each tile's window of virtual rows n*Lv + t (Lv = T +
    E) must lie within the plan's ``wr`` rows. The reduction runs in the
    kernel's order, chunk by chunk of kc channels (zeros past C_in), tap by
    tap, in ring stages of 32 rows, through ``product``."""
    b, t, cin = src.shape
    k, _, cout = kio.shape
    g = cs.ConvShape(b, t, cin, t, cout, k, 1, d, 1, max(-shift, 0))
    wp = cs.win_plan(g, False, torch.float32, 128, bn, kc)
    lv, rows = t + wp["E"], b * t
    assert (k - 1) * d <= wp["E"]
    v = (torch.arange(rows) // t) * lv + torch.arange(rows) % t
    for m0 in range(0, rows, 128):
        assert int(v[m0:m0 + 128].max()) + (k - 1) * d - int(v[m0]) < wp["wr"]
    chunks = wp["chunks"]
    lo, hi = max(-shift, 0), max(shift + (k - 1) * d, 0)
    xp = F.pad(src.transpose(1, 2), (lo, hi, 0, chunks * kc - cin)).transpose(1, 2)
    taps = torch.stack([xp[:, lo + shift + q * d: lo + shift + q * d + t] for q in range(k)], 2)
    a = taps.reshape(rows, k, chunks, kc).permute(0, 2, 1, 3).reshape(rows, -1)
    w = F.pad(kio, (0, 0, 0, chunks * kc - cin)).reshape(k, chunks, kc, cout)
    w = w.permute(1, 0, 2, 3).reshape(-1, cout)
    span = k * kc
    stages = [(c0 * span + s0, c0 * span + min(s0 + 32, span))
              for c0 in range(chunks) for s0 in range(0, span, 32)]
    return product(a, w, stages).reshape(b, t, cout)


def _f32_emulation(x, packed, post_pack=None, pre_pack=None, product=_exact):
    """The fp32 body's schedule on the CPU, in the kernel's order: the
    lrelu'd x (or, with ``pre_pack``, the lrelu'd input, then each output
    phase's upsampling tiles storing the upsampled x and its lrelu); phase j
    runs conv j of every resblock (widest first) on the activated plane the
    kernel's codes name (0 = lrelu(x), 1 and 2 = the resblock's two planes),
    the epilogue adding the bias, at a pair's last conv the residual into h
    in place, and storing the lrelu of the output except after the chain's
    last conv; then the fp32 mean and the post conv. Planes start as NaN, so
    a read of a plane the schedule did not write shows."""
    b, c = x.shape[0], packed["channels"]
    t_out = x.shape[1] * (1 if pre_pack is None else pre_pack["stride"])
    plan = ttail.plan_tail_stage(packed, b, t_out, torch.float32, post_pack is not None, 132,
                                 _two_per_sm, pre=pre_pack)
    bn, kc = plan["bn"], plan["kc"]
    if pre_pack is None:
        xv, ax = x, leaky_relu(x, LRELU_SLOPE)
    else:
        u, taps, c_in = pre_pack["stride"], pre_pack["taps"], pre_pack["c_in"]
        xa = leaky_relu(x, LRELU_SLOPE)
        w = pre_pack["w"].view(u, taps, c_in, c)
        xv = torch.full((b, x.shape[1] * u, c), float("nan"))
        ax = xv.clone()
        for p in range(u):
            val = (_f32_conv(xa, w[p], 1, ttail.pre_offset(pre_pack, p), plan["kc_in"], bn,
                             product) + pre_pack["bias"])
            xv[:, p::u], ax[:, p::u] = val, leaky_relu(val, LRELU_SLOPE)
    t = xv.shape[1]
    per, ps, n_rb = packed["convs_per_rb"], packed["pair_size"], packed["n_rb"]
    planes = [{code: torch.full((b, t, c), float("nan")) for code in ("h", 1, 2)}
              for _ in range(n_rb)]
    act, h_is_x = 0, True
    for j in range(per):
        last, final = j % ps == ps - 1, j == per - 1
        dst = 2 if act == 1 else 1
        for rb in reversed(range(n_rb)):
            k, d, off = packed["convs"][rb * per + j]
            kio = packed["w"][off:off + k * c * c].view(k, c, c)
            src = ax if act == 0 else planes[rb][act]
            res = xv if h_is_x else planes[rb]["h"]
            val = _f32_conv(src, kio, d, -((k - 1) * d // 2), kc, bn, product)
            val = val + packed["bias"][rb * per + j]
            if last:
                val = res + val
                planes[rb]["h"] = val
            if not (last and final):
                planes[rb][dst] = leaky_relu(val, LRELU_SLOPE)
        act = dst
        h_is_x = h_is_x and not last
    acc = torch.zeros((b, t, c))
    for rb in range(n_rb):
        acc = acc + planes[rb]["h"]
    mean = acc / n_rb
    if post_pack is None:
        return mean
    wav = F.conv1d(leaky_relu(mean.transpose(1, 2), 0.01), post_pack["w"].t()[None],
                   post_pack["bias"], padding=3)
    return torch.tanh(wav).transpose(1, 2).contiguous()


@pytest.mark.parametrize("case", ["rb1", "rb2_post", "pre_rb1_post", "pre_rb2", "c12_post"])
def test_fp32_schedule_emulation_matches_the_plain_version(case):
    """The fp32 body's tiles (crossing batch rows, ragged last tile),
    windows, channel chunks (a 12-channel width padded to 16), plane codes
    and the upsampling phase give the plain fp32 version's values within
    1e-5 of its peak (the products exact here; float order only)."""
    gen = torch.Generator().manual_seed(len(case))
    if case.startswith("pre"):
        h = fold_up_config(case[4])
        _, sd = folded_pair(h)
        packed = ttail.pack_generator_tail(h, sd, 1)
        pre = ttail.prepare_upsample(sd, 1, 2, 1)
        x = torch.randn((2, 131, pre["c_in"]), generator=gen) * 0.5
    elif case.startswith("c12"):
        packed = _stage_meta("v1", 0, c=12, weights=lambda o, i, k: torch.randn(
            (o, i, k), generator=gen) * 0.2)
        pre, x = None, torch.randn((3, 77, 12), generator=gen) * 0.5
        sd = {"conv_post.weight": torch.randn((1, 12, 7), generator=gen) * 0.2,
              "conv_post.bias": torch.zeros(1)}
    else:
        h = small_config(case[2])
        _, sd = folded_pair(h)
        packed, pre = ttail.pack_generator_tail(h, sd, 1 if case.endswith("post") else 0), None
        x = torch.randn((3, 100, packed["channels"]), generator=gen) * 0.5
    post_pack = ttail.prepare_post(sd) if case.endswith("post") else None
    want = ttail.fused_tail_stage_reference(x, packed, post_pack, pre)
    got = _f32_emulation(x, packed, post_pack, pre)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.fixture(scope="module")
def v1_stage0():
    """V1 stage 0 at its width (C = 256, k 3/7/11, d 1/3/5) with the
    generator's N(0, 0.01) init, and an input of 64 rows: the deepest
    reduction of the shipped stages (11 x 256 terms)."""
    gen = torch.Generator().manual_seed(0)
    packed = _stage_meta("v1", 0, weights=lambda o, i, k: torch.randn((o, i, k), generator=gen)
                         * 0.01)
    x = torch.randn((1, 64, 256), generator=gen)
    return packed, x, ttail.fused_tail_stage_reference(x, packed)


FP32_TOL = 1e-4  # chip_smoke.py's hold of the fp32 body against its plain version


@pytest.mark.parametrize("product,within", [("3xtf32", True), ("1xtf32", False)])
def test_fp32_product_keeps_fp32_parity_at_v1_stage_0_depth(v1_stage0, product, within):
    """The whole V1 stage 0 through the fp32 body's schedule with its
    3xTF32 product emulated bit for bit (hi/lo split, per-ring-stage
    partials promoted with IEEE adds) stays within FP32_TOL of the plain
    fp32 version (whose peak is 4.4 here); the same schedule with one TF32
    product does not, so the hold tells the two apart."""
    packed, x, want = v1_stage0
    got = _f32_emulation(x, packed, product=THREE_TF32 if product == "3xtf32" else ONE_TF32)
    err = (got - want).abs().max().item()
    assert (err <= FP32_TOL) == within, (err, want.abs().max().item())
    if within:
        assert err <= 1e-6 * want.abs().max().item()  # the plain fp32 version's own order
