"""The CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips on a machine without a CUDA device.
"""

import pytest
import torch

from hifigan_tpu_torch.config import AttrDict, get_config
from hifigan_tpu_torch.models import Generator, fold_weight_norm
from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
from hifigan_tpu_torch.ops import conv_stack as tstack
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
@pytest.mark.parametrize("resblock,stage,post,seq,batch", [
    ("1", 0, False, 1000, 2),  # C=128: 64-column tiles, two 64-channel chunks
    ("1", 2, True, 777, 3),    # C=32: 32-column tiles, post folded, tiles across batch rows
    ("2", 2, True, 300, 1),    # ResBlock2 chain, C=32, post folded
    ("1", 0, True, 259, 3),    # one stage of C=12 (set below): padded to a 16-channel chunk
])
def test_kernel_matches_plain_fp32(no_tf32, resblock, stage, post, seq, batch):
    """The fp32 body (3xTF32 on the tensor cores, one cooperative launch per
    stage) against its plain version within 1e-4, as chip_smoke.py holds it."""
    h = _config(resblock, 256)
    ch = 256 // (2 ** (stage + 1))
    if (stage, post) == (0, True):
        h.update(upsample_rates=[2], upsample_kernel_sizes=[4], upsample_initial_channel=24)
        ch = 12
    sd = _state(h)
    packed = ttail.pack_generator_tail(h, sd, stage, device="cuda")
    post_pack = ttail.prepare_post(sd, device="cuda") if post else None
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((batch, seq, ch), device="cuda", generator=g) * 0.3
    launches = ttail.LAUNCHES
    got = ttail.fused_tail_stage(x, packed, post_pack=post_pack)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == launches + 1
    ref = ttail.fused_tail_stage_reference(x, packed, post_pack)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name,stage,post,seq,batch", [
    ("v1", 0, False, 300, 1),    # C=256: two 128-column tiles per row tile
    ("v1", 1, False, 777, 3),    # C=128, ragged last row tile
    ("v1", 2, False, 2048, 1),   # C=64
    ("v1", 3, True, 1000, 3),    # C=32, post conv folded
    ("v2", 2, False, 259, 3),    # C=16
    ("v2", 3, True, 130, 1),     # C=8: input padded to 16, post conv folded
    ("v3", 0, False, 500, 3),    # ResBlock2 chains, C=128
    ("v3", 2, True, 333, 1),     # ResBlock2, C=32, post conv folded
])
def test_kernel_matches_plain_bf16(card, no_tf32, name, stage, post, seq, batch):
    """The tensor-core body (one cooperative launch per stage) against its
    plain version within 2^-4 of the plain version's peak, as chip_smoke.py
    holds it."""
    h = get_config(name)
    sd = _state(h)
    packed = ttail.pack_generator_tail(h, sd, stage, dtype=torch.bfloat16, device=card)
    post_pack = ttail.prepare_post(sd, dtype=torch.bfloat16, device=card) if post else None
    g = torch.Generator(device=card).manual_seed(stage)
    x = (torch.randn((batch, seq, packed["channels"]), device=card, generator=g) * 0.5)
    x = x.to(torch.bfloat16)
    launches = ttail.LAUNCHES
    got = ttail.fused_tail_stage(x, packed, post_pack=post_pack)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == launches + 1
    ref = ttail.fused_tail_stage_reference(x, packed, post_pack)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert bool(torch.isfinite(got).all())
    peak = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -4 * peak


@pytest.mark.parametrize("name,stage,post,t_in,batch,dtype", [
    ("v1", 2, False, 1000, 2, torch.bfloat16),   # C=64 from 128, ragged last input tile
    ("v1", 3, True, 777, 1, torch.bfloat16),     # C=32 from 64, post conv folded
    ("v2", 2, False, 259, 3, torch.bfloat16),    # C=16 from 32
    ("v2", 3, True, 130, 1, torch.bfloat16),     # C=8 from 16: output padded to 16
    ("v1", 2, False, 300, 2, torch.float32),     # the 3xTF32 body: C=64 from 128
    ("v1", 3, True, 257, 1, torch.float32),
])
def test_kernel_with_pre_pack_matches_plain(card, no_tf32, name, stage, post, t_in, batch, dtype):
    """The folded upsampler (lrelu -> ConvTranspose1d stride 2) in both
    bodies against the plain version: fp32 within 1e-4, bf16 within 2^-4
    of the plain version's peak, as chip_smoke.py holds them."""
    h = get_config(name)
    sd = _state(h)
    u, k = h["upsample_rates"][stage], h["upsample_kernel_sizes"][stage]
    packed = ttail.pack_generator_tail(h, sd, stage, dtype=dtype, device=card)
    pre = ttail.prepare_upsample(sd, stage, u, (k - u) // 2, dtype=dtype, device=card)
    post_pack = ttail.prepare_post(sd, dtype=dtype, device=card) if post else None
    g = torch.Generator(device=card).manual_seed(stage)
    x = (torch.randn((batch, t_in, pre["c_in"]), device=card, generator=g) * 0.5).to(dtype)
    launches = ttail.LAUNCHES
    got = ttail.fused_tail_stage(x, packed, post_pack=post_pack, pre_pack=pre)
    torch.cuda.synchronize()
    assert ttail.LAUNCHES == launches + 1
    ref = ttail.fused_tail_stage_reference(x, packed, post_pack, pre)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.shape[1] == t_in * u and bool(torch.isfinite(got).all())
    peak = ref.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -4 * peak
    assert (got.float() - ref.float()).abs().max().item() <= tol


@requires_cuda
def test_fast_vocoder_fold_up_launches_kernel_per_stage(no_tf32):
    """fold_up=True: every stage of a stride-2 config folds its upsampler,
    still one launch per stage, within 2e-4 of the fp32 Generator."""
    h = _config("1", 128)
    sd = _state(h)
    mel = torch.randn((2, 80, 20), generator=torch.Generator().manual_seed(3)) * 2 - 5
    fast = make_fast_vocoder(h, sd, dtype=torch.float32, fold_up=True)
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
def test_streaming_vocoder_on_the_card_matches_the_generator(no_tf32):
    """The stateful streamer with every stage's MRF in the kernel (fp32,
    the SIMT body, at chunk lengths) equals the whole-utterance Generator
    from the delay on, one launch per stage and chunk."""
    from hifigan_tpu_torch.models.streaming import make_streaming_vocoder

    h = _config("1", 128)
    sd = _state(h)
    mel = torch.randn((2, 80, 160), generator=torch.Generator().manual_seed(4)) * 2 - 5
    init_state, step, delay = make_streaming_vocoder(h, sd, dtype=torch.float32)
    state, outs = init_state(2), []
    launches = ttail.LAUNCHES
    for s in range(0, 160, 32):
        state, wav = step(state, mel[:, :, s:s + 32])
        outs.append(wav.cpu())
    assert ttail.LAUNCHES == launches + 5 * len(h["upsample_rates"])
    stream = torch.cat(outs, dim=-1)
    gen = Generator(h, folded=True)
    gen.load_state_dict(sd)
    with torch.no_grad():
        full = gen(mel)
    total = full.shape[-1]
    assert (stream[:, :, 2 * delay:] - full[:, :, delay:total - delay]).abs().max().item() <= 2e-4


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


def _stack(specs, c0, seq, batch, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, seq, c0), device="cuda", generator=g) * 0.5
    ks, bs, c = [], [], c0
    for sp in specs:
        fan = sp.kernel * (c // sp.groups)
        ks.append(torch.randn((sp.kernel, c // sp.groups, sp.c_out), device="cuda",
                              generator=g) * (1.5 / fan ** 0.5))
        bs.append(torch.randn((sp.c_out,), device="cuda", generator=g) * 0.1)
        c = sp.c_out
    return x, ks, bs


_L = tstack.LayerSpec
STACKS = {
    # MSD-shaped: strided grouped layers (odd lengths), a dense layer, conv_post
    "msd": ([_L(64, 41, 2, 4, 20, 20, 0.1), _L(128, 41, 4, 16, 20, 20, 0.1),
             _L(128, 5, 1, 1, 2, 2, 0.1), _L(1, 3, 1, 1, 1, 1, 1.0)], 64, 333),
    # asymmetric padding, stride 3, wide groups
    "odd": ([_L(96, 7, 3, 2, 4, 1, 0.2), _L(48, 3, 1, 3, 0, 2, 0.1)], 32, 101),
    # the narrow edges of the conv core: one input channel, 4-channel groups
    # (rows narrower than a 16-byte copy in bf16), one output channel; ragged T
    "narrow": ([_L(16, 15, 1, 1, 7, 7, 0.1), _L(16, 7, 2, 4, 3, 3, 0.1),
                _L(8, 5, 1, 2, 2, 2, 0.2), _L(1, 3, 1, 1, 1, 1, 1.0)], 1, 157),
}


@requires_cuda
@pytest.mark.parametrize("name", sorted(STACKS))
def test_conv_stack_kernels_match_plain_fp32(no_tf32, name):
    specs, c0, seq = STACKS[name]
    x, ks, bs = _stack(specs, c0, seq, 3, 0)
    before = tstack.launches()
    xk = x.clone().requires_grad_()
    kk = [k.clone().requires_grad_() for k in ks]
    bk = [b.clone().requires_grad_() for b in bs]
    ys = tstack.fused_conv_stack(xk, kk, bk, specs)
    torch.cuda.synchronize()
    assert tstack.LAUNCHES_FWD == before["fwd"] + len(specs)
    ref = tstack.fused_conv_stack_reference(x, ks, bs, specs)
    for y, r in zip(ys, ref):
        assert y.shape == r.shape and y.dtype == r.dtype
        assert (y - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)
    g = torch.Generator(device="cuda").manual_seed(1)
    dys = [torch.randn(y.shape, device="cuda", generator=g) * 0.1 for y in ys]
    dys[0] = None  # a dead cotangent
    loss = sum((y * d).sum() for y, d in zip(ys, dys) if d is not None)
    got = torch.autograd.grad(loss, [xk, *kk, *bk])
    torch.cuda.synchronize()
    assert tstack.LAUNCHES_BWD_DX == before["bwd_dx"] + len(specs)
    assert tstack.LAUNCHES_BWD_DW == before["bwd_dw"] + len(specs)
    dx, dks, dbs = tstack.fused_conv_stack_backward_reference(
        x, ks, [y.detach() for y in ys], dys, specs)
    for a, b in zip(got, [dx, *dks, *dbs]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@requires_cuda
@pytest.mark.parametrize("name", sorted(STACKS))
def test_conv_stack_kernels_match_plain_bf16(no_tf32, name):
    specs, c0, seq = STACKS[name]
    x, ks, bs = _stack(specs, c0, seq, 3, 4)
    x = x.bfloat16()
    ks = [k.bfloat16() for k in ks]
    xk = x.clone().requires_grad_()
    kk = [k.clone().requires_grad_() for k in ks]
    bk = [b.clone().requires_grad_() for b in bs]
    ys = tstack.fused_conv_stack(xk, kk, bk, specs)
    for y, r in zip(ys, tstack.fused_conv_stack_reference(x, ks, bs, specs)):
        assert y.dtype == r.dtype == torch.bfloat16
        assert (y.float() - r.float()).abs().max().item() <= 2.0 ** -4 * r.float().abs().max().item()
    g = torch.Generator(device="cuda").manual_seed(5)
    dys = [(torch.randn(y.shape, device="cuda", generator=g) * 0.1).bfloat16() for y in ys]
    got = torch.autograd.grad(ys, [xk, *kk, *bk], dys)
    dx, dks, dbs = tstack.fused_conv_stack_backward_reference(
        x, ks, [y.detach() for y in ys], dys, specs)
    for a, b in zip(got, [dx, *dks, *dbs]):
        assert (a.float() - b.float()).abs().max().item() <= 2.0 ** -4 * b.float().abs().max().item()


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_stack_backward_is_bit_identical(no_tf32, dtype):
    """dW's splits and db's row blocks are summed in a fixed order: no float atomics."""
    specs, c0, seq = STACKS["msd"]
    x, ks, bs = _stack(specs, c0, seq, 4, 6)
    xk = x.to(dtype).requires_grad_()
    kk = [k.to(dtype).requires_grad_() for k in ks]
    bk = [b.clone().requires_grad_() for b in bs]
    ys = tstack.fused_conv_stack(xk, kk, bk, specs)
    dys = [torch.ones_like(y) * 0.01 for y in ys]
    first = torch.autograd.grad(ys, [xk, *kk, *bk], dys, retain_graph=True)
    second = torch.autograd.grad(ys, [xk, *kk, *bk], dys)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@requires_cuda
def test_conv_stack_skips_weight_and_input_grads(no_tf32):
    specs, c0, seq = STACKS["msd"]
    x, ks, bs = _stack(specs, c0, seq, 2, 2)
    kk = [k.clone().requires_grad_() for k in ks]
    before = tstack.launches()
    ys = tstack.fused_conv_stack(x, kk, bs, specs, weight_grads=False)
    grads = torch.autograd.grad(ys[-1].sum(), kk)
    assert all(not g.any() for g in grads)
    after = tstack.launches()
    assert after["bwd_dw"] == before["bwd_dw"]
    assert after["bwd_dx"] == before["bwd_dx"] + len(specs) - 1  # x needs no grad: no layer-0 dx


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2048, 1025])
def test_zoned_discriminator_on_the_card_matches_the_cpu(no_tf32, t, dtype):
    """``conv_impl='fused_zoned'`` at width 128: the zone chain's kernels,
    lane masks on the partial rows at 1025, against the same module on the
    CPU (the plain stack): every map, its zeros (the masked lanes) exact,
    and in fp32 the gradient of every parameter within 1e-3 of its norm."""
    from hifigan_tpu_torch.models import DiscriminatorS

    cpu = DiscriminatorS(conv_impl="fused_zoned", dtype=dtype,
                         generator=torch.Generator().manual_seed(t))
    card = DiscriminatorS(conv_impl="fused_zoned", dtype=dtype).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((3, t), generator=torch.Generator().manual_seed(1)) * 0.3
    before = tstack.launches()
    (lc, fc), (lk, fk) = cpu(x), card(x.cuda())
    assert tstack.launches()["fwd"] == before["fwd"] + 7
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -4
    for a, b in zip([lk, *fk], [lc, *fc]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a.cpu().float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()
        assert bool((a.cpu()[b == 0] == 0).all())
    if dtype == torch.bfloat16:
        return
    gc = torch.autograd.grad(lc.sum() + sum(f.square().mean() for f in fc), list(cpu.parameters()))
    gk = torch.autograd.grad(lk.sum() + sum(f.square().mean() for f in fk),
                             list(card.parameters()))
    for a, b in zip(gk, gc):
        assert (a.cpu() - b).norm().item() <= 1e-3 * b.norm().item()


@requires_cuda
def test_conv_stack_wrapper_rejects_bad_inputs():
    specs, c0, seq = STACKS["odd"]
    x, ks, bs = _stack(specs, c0, seq, 1, 3)
    with pytest.raises(TypeError):
        tstack.fused_conv_stack(x.half(), ks, bs, specs)  # dtype
    with pytest.raises(ValueError):
        tstack.fused_conv_stack(x[:, ::2], ks, bs, specs)  # not contiguous
    with pytest.raises(ValueError):
        tstack.fused_conv_stack(x, [ks[0].cpu(), ks[1]], bs, specs)  # device
    with pytest.raises(ValueError):
        tstack.fused_conv_stack(x[:, :, :16].contiguous(), ks, bs, specs)  # channels


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _member_segments(elements: int = 3) -> list:
    """The segments of a two-member all-in-one discriminator of the
    production family (a roll: and an all: block), recorded on the CPU."""
    from hifigan_tpu_torch.dsl import fused_member as fm
    from hifigan_tpu_torch.dsl.module import ConfigurableModule
    from hifigan_tpu_torch.dsl.parsing import parse_layers
    from hifigan_tpu_torch.dsl.static_configs import get_discriminator_config

    cfg = get_discriminator_config(parse_layers(
        ["roll:1,9,1", "roll:1,5,2", "roll:2,5,2", "all:3,5,2", "roll:4,3,1"]), 1, 2)
    disc = ConfigurableModule(cfg, mel_sampling_rate_override=16000)
    disc.build(torch.zeros(1, 144, 1), generator=torch.Generator().manual_seed(0))
    rec, real = [], fm.fused_stream_graph

    def spy(seg, inputs, tables, biases, members=1, weight_grads=True):
        rec.append((seg, inputs, tables, biases, members))
        return real(seg, inputs, tables, biases, members=members, weight_grads=weight_grads)

    fm.fused_stream_graph = spy
    try:
        with torch.no_grad():
            disc(torch.randn(elements, 144, 1, generator=torch.Generator().manual_seed(1)))
    finally:
        fm.fused_stream_graph = real
    return rec


def _stream_graph_kernels_match_plain(card, dtype):
    """Every segment: one launch a pass, every level and dx/dW/db against
    the plain version (fp32 within 1e-5 / 1e-4; bf16 within 2^-4 of the
    plain tensor's peak), two backward runs bit-identical."""
    from hifigan_tpu_torch.ops import stream_graph as sg

    gen = torch.Generator().manual_seed(2)
    for seg, ins, tabs, bs, m in _member_segments():
        ins = [x.to(card, dtype) for x in ins]
        tabs = [t.to(card, dtype) for t in tabs]
        bs = [None if b is None else b.to(card) for b in bs]
        before = sg.launches()
        ys = sg.fused_stream_graph(seg, ins, tabs, bs, members=m)
        assert sg.launches() == dict(before, fwd=before["fwd"] + 1)
        for a, b in zip(ys, sg.fused_stream_graph_reference(seg, ins, tabs, bs, m)):
            assert a.dtype == b.dtype == dtype
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            else:
                assert (a.float() - b.float()).abs().max() <= 2.0 ** -4 * b.float().abs().max()
        dys = [torch.randn(y.shape, generator=gen).to(card, dtype) for y in ys]
        xs = [x.clone().requires_grad_() for x in ins]
        tt = [t.clone().requires_grad_() for t in tabs]
        bb = [None if b is None else b.clone().requires_grad_() for b in bs]
        outs = sg.fused_stream_graph(seg, xs, tt, bb, members=m)
        wrt = xs + tt + [b for b in bb if b is not None]
        before = sg.launches()
        got = torch.autograd.grad(outs, wrt, dys, retain_graph=True)
        assert sg.launches() == dict(before, bwd_dx=before["bwd_dx"] + 1,
                                     bwd_dw=before["bwd_dw"] + 1)
        again = torch.autograd.grad(outs, wrt, dys)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        dxs, dws, dbs = sg.fused_stream_graph_backward_reference(
            seg, ins, [o.detach() for o in outs], dys, tabs, m)
        want = list(dxs) + list(dws) + [d for d, b in zip(dbs, bs) if b is not None]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            else:
                assert (a.float() - b.float()).abs().max() <= 2.0 ** -4 * b.float().abs().max()


def test_stream_graph_kernels_match_plain_fp32(card, no_tf32):
    _stream_graph_kernels_match_plain(card, torch.float32)


def test_stream_graph_kernels_match_plain_bf16(card, no_tf32):
    _stream_graph_kernels_match_plain(card, torch.bfloat16)


def test_stream_graph_wrapper_rejects_bad_inputs(card):
    from hifigan_tpu_torch.ops import stream_graph as sg

    seg = sg.Segment(levels=(sg.Level(8, 1, True), sg.Level(8, 2)),
                     ops=(sg.Op(1, (sg.Edge(0, 1, 3, 1, 1, 1),), "lrelu", 0.1),))
    x = torch.zeros(2, 8, 1, device=card)
    with pytest.raises(ValueError):
        sg.fused_stream_graph(seg, [x], [torch.zeros(1, 3, 1, 3, device=card)], [None])
    with pytest.raises(TypeError):
        sg.fused_stream_graph(seg, [x.half()], [torch.zeros(1, 3, 1, 2, device=card)], [None])
    with pytest.raises(ValueError):
        sg.fused_stream_graph(seg, [x], [torch.zeros(1, 3, 1, 2)], [None])


def test_stream_fusion_launches_the_kernel_per_run(card, no_tf32):
    """``stream_impl='fused'`` on CUDA tensors: one stream-graph forward
    launch a fused run, forward and input gradient within 1e-4 of the
    interpreter (a small distillation generator: 2, 6 and 30 channels)."""
    from hifigan_tpu_torch.dsl import stream_fusion as sf
    from hifigan_tpu_torch.dsl.module import ConfigurableModule
    from hifigan_tpu_torch.dsl.parsing import parse_layers
    from hifigan_tpu_torch.dsl.static_configs import get_generator_configs
    from hifigan_tpu_torch.ops import stream_graph as sg

    g = get_generator_configs(parse_layers([
        "res.1,none:1,3,1,1,1,1e-00", "res.1|conv.1,sub_res:1,3,3,1,1,1e-00",
        "res.1|conv.1,sub_res:3,3,5,1,1,1e-00"]), expansion_size=2, embedding_size=15)
    x = torch.randn(2, 1500, 1, generator=torch.Generator().manual_seed(0))
    fused = ConfigurableModule(g["encoder"], stream_impl="fused").build(x[:1])
    plain = ConfigurableModule(g["encoder"]).build(x[:1])
    plain.load_state_dict(fused.state_dict())
    fused, plain = fused.to(card), plain.to(card)
    xc = x.to(card).requires_grad_()
    rec = []
    before = sg.launches()
    emb, _ = sf.eval_stream_fused(fused, fused.config, xc, "m", rec)
    torch.cuda.synchronize()
    assert len(rec) == 3 and sg.launches()["fwd"] - before["fwd"] == len(rec)
    want = plain(xc)
    loss = sum((emb[k] * want[k].detach()).sum() for k in emb)
    (gx,) = torch.autograd.grad(loss, [xc])
    (gw,) = torch.autograd.grad(sum((want[k] * want[k].detach()).sum() for k in want), [xc])
    for k in emb:
        torch.testing.assert_close(emb[k], want[k], rtol=1e-4,
                                   atol=1e-4 * want[k].abs().max().item())
    torch.testing.assert_close(gx, gw, rtol=1e-4, atol=1e-4 * gw.abs().max().item())


# (Cin, Cout, K, stride, dilation, groups, padding, slope, T): MSD-shaped layers
# (conv_0's one input channel, strided grouped, conv_post's one output), a
# dilated classifier conv, asymmetric padding at stride 3
MSD_CASES = [(1, 32, 15, 1, 1, 1, 7, 0.1, 300), (32, 64, 41, 2, 1, 4, 20, 0.1, 301),
             (64, 64, 41, 4, 1, 16, 20, 0.1, 150), (64, 1, 3, 1, 1, 1, 1, 1.0, 40),
             (24, 20, 3, 1, 9, 1, 9, 0.1, 77), (12, 18, 7, 3, 1, 3, (4, 1), 0.2, 101),
             # 4-channel groups, dilated; a stride above the kernel; a second
             # channel chunk with a long dilation
             (16, 16, 5, 1, 3, 4, 6, 0.1, 123), (16, 24, 3, 5, 1, 1, 1, 0.1, 64),
             (144, 72, 3, 1, 27, 1, 27, 0.1, 90)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MSD_CASES, ids=[f"c{i}" for i in range(len(MSD_CASES))])
def test_msd_conv_kernels_match_plain(card, no_tf32, case, dtype):
    from hifigan_tpu_torch.ops import msd_conv as tmsd

    ci, co, k, s, d, g, p, slope, t = case
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((3, t, ci), device=card, generator=gen) * 0.5).to(dtype)
    kern = torch.randn((k, ci // g, co), device=card, generator=gen) / (k * ci // g) ** 0.5
    bias = torch.randn((co,), device=card, generator=gen) * 0.1
    kw = dict(stride=s, padding=p, dilation=d, groups=g, slope=slope)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -4
    before = tmsd.launches()
    xk = x.clone().requires_grad_()
    y = tmsd.msd_conv1d_lrelu(xk, kern, bias, **kw)
    torch.cuda.synchronize()
    assert tmsd.launches()["fwd"] == before["fwd"] + 1
    ref = tmsd.msd_conv1d_lrelu_reference(x, kern, bias, **kw)
    assert y.shape == ref.shape and y.dtype == ref.dtype == dtype
    assert (y.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()
    dy = torch.randn(y.shape, device=card, generator=gen).to(dtype)
    (dx,) = torch.autograd.grad(y, [xk], dy)
    torch.cuda.synchronize()
    assert tmsd.launches()["bwd_dx"] == before["bwd_dx"] + 1
    want, _, _ = tmsd.msd_conv1d_lrelu_backward_reference(x, kern, y.detach(), dy, **kw)
    assert dx.dtype == dtype
    assert (dx.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


def test_msd_conv_skips_dx_for_an_input_without_grad(card):
    from hifigan_tpu_torch.ops import msd_conv as tmsd

    kern = torch.randn((5, 8, 16), device=card, requires_grad=True)
    before = tmsd.launches()
    y = tmsd.msd_conv1d_lrelu(torch.randn((2, 40, 8), device=card), kern, None, padding=2,
                              slope=0.1)
    (dk,) = torch.autograd.grad(y.sum(), [kern])
    assert tmsd.launches() == {"fwd": before["fwd"] + 1, "bwd_dx": before["bwd_dx"]}
    assert dk.shape == kern.shape and bool(dk.any())


def test_msd_conv_wrapper_rejects_bad_inputs(card):
    from hifigan_tpu_torch.ops import msd_conv as tmsd

    x, kern = torch.zeros((1, 32, 8), device=card), torch.zeros((3, 4, 8), device=card)
    with pytest.raises(TypeError):
        tmsd.msd_conv1d_lrelu(x.half(), kern, None, groups=2)  # dtype
    with pytest.raises(ValueError):
        tmsd.msd_conv1d_lrelu(x, kern, None)  # kernel does not fit 1 group
    with pytest.raises(ValueError):
        tmsd.msd_conv1d_lrelu(x, kern.cpu(), None, groups=2)  # device
    with pytest.raises(ValueError):
        tmsd.msd_conv1d_lrelu(x, kern, None, groups=2, stride=2, dilation=2)  # both


@pytest.mark.parametrize("t", [8192, 8192 + 113])
def test_log_mel_kernel_matches_plain(card, no_tf32, t):
    from hifigan_tpu_torch.audio.mel import MelConfig
    from hifigan_tpu_torch.ops import logmel as tlogmel

    cfg = MelConfig()
    y = (torch.randn((3, t), device=card, generator=torch.Generator(device=card).manual_seed(t))
         * 0.3).clamp(-1, 1)
    launches = tlogmel.LAUNCHES
    yk = y.clone().requires_grad_()
    got = tlogmel.fused_log_mel(yk, cfg)
    torch.cuda.synchronize()
    assert tlogmel.LAUNCHES == launches + 1
    yp = y.clone().requires_grad_()
    want = tlogmel.fused_log_mel_reference(yp, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 2e-4 + 1e-4 * want.abs()).all())
    (gk,) = torch.autograd.grad(torch.sin(got).sum(), yk)
    (gp,) = torch.autograd.grad(torch.sin(want).sum(), yp)
    assert (gk - gp).abs().max().item() <= 1e-4 * gp.abs().max().item()


@pytest.mark.parametrize("n_fft", [512, 2048])
def test_log_mel_fft_body_radix2_sizes_match_plain(card, no_tf32, n_fft):
    """The FFT body with its radix-2 first pass (log2 n_fft odd) against
    the plain version, forward within 2e-4 + 1e-4 |plain|."""
    from hifigan_tpu_torch.audio.mel import MelConfig
    from hifigan_tpu_torch.ops import logmel as tlogmel

    cfg = MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4)
    assert tlogmel.plan(cfg).route == "fft" and tlogmel.fft_passes(n_fft)[0] == 2
    y = (torch.randn((3, 20 * n_fft + 77), device=card,
                     generator=torch.Generator(device=card).manual_seed(n_fft)) * 0.3).clamp(-1, 1)
    got = tlogmel.fused_log_mel(y, cfg)
    want = tlogmel.fused_log_mel_reference(y, cfg)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 2e-4 + 1e-4 * want.abs()).all())


def _log_mel_body_matches_plain(card, n_fft: int, body: str, frames: int = 8):
    """The route ``body`` at n_fft / n_fft // 4 (``frames`` a block on an FFT
    route): one launch of it, forward and gradient against the plain
    version."""
    from hifigan_tpu_torch.audio.mel import MelConfig
    from hifigan_tpu_torch.ops import logmel as tlogmel

    cfg = MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4)
    assert tlogmel.supports_fused_log_mel(cfg)
    assert tlogmel.plan(cfg).route == body and tlogmel.plan(cfg).frames == (
        0 if body == "dense" else frames)
    y = (torch.randn((3, max(9000, 3 * n_fft)), device=card,
                     generator=torch.Generator(device=card).manual_seed(3)) * 0.3).clamp(-1, 1)
    launches = dict(tlogmel.BODY_LAUNCHES)
    yk = y.clone().requires_grad_()
    got = tlogmel.fused_log_mel(yk, cfg)
    torch.cuda.synchronize()
    assert tlogmel.BODY_LAUNCHES == dict(launches, **{body: launches[body] + 1})
    yp = y.clone().requires_grad_()
    want = tlogmel.fused_log_mel_reference(yp, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 2e-4 + 1e-4 * want.abs()).all())
    (gk,) = torch.autograd.grad(torch.sin(got).sum(), yk)
    (gp,) = torch.autograd.grad(torch.sin(want).sum(), yp)
    assert (gk - gp).abs().max().item() <= 1e-4 * gp.abs().max().item()


@pytest.mark.parametrize("n_fft", [6404, 12000])
def test_log_mel_dense_body_matches_plain(card, no_tf32, n_fft):
    """A geometry whose buffers overflow shared memory even at 2 frames a
    block (6404 = 4 x 1601 through Bluestein, 12000 with a pass plan) keeps
    the dense-DFT body: forward and gradient against the plain version."""
    _log_mel_body_matches_plain(card, n_fft, "dense")


@pytest.mark.parametrize("n_fft", [1200, 960, 800])
def test_log_mel_mixed_radix_body_matches_plain(card, no_tf32, n_fft):
    """n_fft = 2^a 3^b 5^c that is not a power of two takes the FFT body's
    radix-3 and radix-5 passes: forward and gradient against the plain
    version."""
    _log_mel_body_matches_plain(card, n_fft, "fft")


@pytest.mark.parametrize("n_fft,frames", [(1100, 8), (1764, 4), (1716, 4), (448, 8)])
def test_log_mel_prime_radix_body_matches_plain(card, no_tf32, n_fft, frames):
    """n_fft with a factor 7, 11 or 13 (1100 = 2^2 5^2 11, 1764 = 2^2 3^2
    7^2, 1716 = 2^2 3 11 13, 448 = 2^6 7) takes the FFT body's radix-7, 11
    and 13 passes: forward and gradient against the plain version."""
    _log_mel_body_matches_plain(card, n_fft, "fft", frames)


@pytest.mark.parametrize("n_fft,frames", [(808, 8), (1028, 4), (1088, 4), (2068, 2)])
def test_log_mel_bluestein_body_matches_plain(card, no_tf32, n_fft, frames):
    """n_fft with a prime factor above 13 (808 = 8 x 101, 1028 = 4 x 257,
    1088 = 2^6 17, 2068 = 4 x 11 x 47) takes the Bluestein route at 8, 4 and
    2 frames a block: forward and gradient against the plain version."""
    _log_mel_body_matches_plain(card, n_fft, "bluestein", frames)


@pytest.mark.parametrize("n_fft,frames", [(1764, 4), (5600, 4), (3200, 2), (4096, 2)])
def test_log_mel_fft_body_at_fewer_frames_matches_plain(card, no_tf32, n_fft, frames):
    """n_fft whose buffers leave no room for two blocks an SM at 8 frames
    runs the FFT body at 4 or 2: forward and gradient against the plain
    version."""
    _log_mel_body_matches_plain(card, n_fft, "fft", frames)


@pytest.mark.parametrize("n,t,c,k,s,p", [(6, 14560, 12, 31, 1, 15), (4, 8192, 1, 4, 2, 2),
                                         (2, 64, 8, 4, 2, 2)])
@pytest.mark.parametrize("channels_first", [False, True])
def test_avg_pool1d_gradient_matches_the_cpu(card, n, t, c, k, s, p, channels_first):
    """The pool's input gradient on the card equals the CPU's for a
    contiguous (N, W, C) input (a per-layer conv kernel's output), one with
    channels-first memory (a cuDNN conv's output) and one channel (the MSD's
    waveform), where F.avg_pool1d's CUDA backward is wrong for the first and
    the last."""
    from hifigan_tpu_torch.ops.conv import avg_pool1d

    g = torch.Generator().manual_seed(t + c)
    x = torch.randn((n, t, c), generator=g)
    if channels_first:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    xc, xd = x.clone().requires_grad_(), x.to(card).requires_grad_()
    want = avg_pool1d(xc, k, s, padding=p)
    got = avg_pool1d(xd, k, s, padding=p)
    dy = torch.randn(want.shape, generator=g)
    (gw,) = torch.autograd.grad(want, xc, dy)
    (gg,) = torch.autograd.grad(got, xd, dy.to(card))
    assert (got.cpu() - want).abs().max().item() <= 1e-6
    assert (gg.cpu() - gw).abs().max().item() <= 1e-6
