"""Fused HiFi-GAN MRF stage: one CUDA kernel per stage, and its plain version.

Replaces ``hifigan_tpu/ops/pallas/resblock_tail.py::fused_tail_stage`` (the
Pallas call at :395). A stage computes, over x (B, T, C)::

    out = mean_j ResBlock_j(x)       ResBlock: h <- h + conv(lrelu0.1(...))

with 'same' dilated convs zero-padded at the true sequence edges before every
conv, each conv's output rounded to the working dtype and the mean taken in
fp32. ``post_pack`` folds the generator tail (lrelu 0.01 -> conv_post k7
C->1 -> tanh) into the same pass and returns (B, T, 1) float32.
``pre_pack`` (:func:`prepare_upsample`) folds the stage's head in front of
it: x is then the previous stage's output (B, T_in, C_in) and the stage
first computes lrelu(0.1) -> ConvTranspose1d(stride u) + bias, rounded to
the working dtype once, so T = T_in * u.

The kernel (``csrc/resblock_tail.cu``) is bound by arithmetic: a V1 request
of 256 mel frames at B=1 does about 152 GFLOP of MRF work, and the source
note there says what the design does about that. It has two bodies, chosen
by dtype, on one schedule: one cooperative launch per stage that walks the
whole sequence conv by conv, a grid-wide barrier between convs and the
activations in device-memory planes (no halo recompute, every SM busy at
B=1). bf16, the served path, runs the convs on bf16 tensor cores; fp32 on
the tensor cores as 3xTF32 through the conv core of ``csrc/conv_core.cuh``
(fp32-class error, each ring stage's sum promoted with IEEE adds).
:func:`plan_tail_stage` sizes either on the host.

The TPU kernel's time-blocked tables, lane folding and VMEM split heuristic
are not carried over: the CUDA kernel takes the plain per-conv taps
(K, C, C) and each conv's dilation, packed once on the host by
:func:`pack_generator_tail`, and the upsampler's taps split by output phase
(:func:`prepare_upsample`), which works for any stride.

- :func:`fused_tail_stage_reference` is the plain PyTorch version (conv by
  conv with ``F.conv1d``, fp32 accumulation).
- :func:`fused_tail_stage` takes the plain version for a CPU tensor; for a
  CUDA tensor it launches the kernel or raises.
- ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops import conv_stack as cs
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, leaky_relu

LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_POST_K = 7


def _radius(k: int, d: int) -> int:
    return (k - 1) * d // 2


def prepare_tail_stage(convs: list[list[tuple[torch.Tensor, torch.Tensor, int]]],
                       pair_size: int, dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cpu") -> dict:
    """Pack one stage's resblock convs for :func:`fused_tail_stage`.

    convs: [resblock][conv] of (weight (O, I, K) in torch layout, bias (C,),
    dilation), in execution order. pair_size: convs per residual connection
    (2 for ResBlock1, 1 for ResBlock2). Taps are stored (K, C_in, C_out),
    every conv's after the last, in ``dtype`` on ``device``.
    """
    n_per = {len(rb) for rb in convs}
    if len(n_per) != 1:
        raise ValueError("every resblock of a stage must have the same number of convs")
    (convs_per_rb,) = n_per
    if convs_per_rb % pair_size:
        raise ValueError("convs per resblock must be a multiple of pair_size")
    taps, biases, meta = [], [], []
    off = 0
    for rb in convs:
        for weight, bias, d in rb:
            k = int(weight.shape[2])
            kio = weight.detach().permute(2, 1, 0).contiguous()
            taps.append(kio.reshape(-1))
            biases.append(bias.detach().reshape(-1))
            meta.append((k, int(d), off))
            off += kio.numel()
    channels = int(convs[0][0][0].shape[0])
    desc = torch.tensor([v for m in meta for v in m], dtype=torch.int32)
    return {
        "w": torch.cat(taps).to(device=device, dtype=dtype),
        "bias": torch.stack(biases).to(device=device, dtype=dtype),
        "desc": desc.to(device),
        "convs": meta,
        "n_rb": len(convs),
        "convs_per_rb": convs_per_rb,
        "pair_size": pair_size,
        "channels": channels,
    }


def pack_generator_tail(h, state_dict: dict, stage_index: int,
                        dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cpu") -> dict:
    """Stage ``stage_index``'s resblock convs from a folded Generator state_dict."""
    num_kernels = len(h["resblock_kernel_sizes"])
    is_rb1 = str(h["resblock"]) == "1"
    convs = []
    for j in range(num_kernels):
        pre = f"resblocks.{stage_index * num_kernels + j}"
        rb = []
        for i, d in enumerate(h["resblock_dilation_sizes"][j]):
            if is_rb1:
                rb.append((state_dict[f"{pre}.convs1.{i}.weight"],
                           state_dict[f"{pre}.convs1.{i}.bias"], d))
                rb.append((state_dict[f"{pre}.convs2.{i}.weight"],
                           state_dict[f"{pre}.convs2.{i}.bias"], 1))
            else:
                rb.append((state_dict[f"{pre}.convs.{i}.weight"],
                           state_dict[f"{pre}.convs.{i}.bias"], d))
        convs.append(rb)
    return prepare_tail_stage(convs, 2 if is_rb1 else 1, dtype=dtype, device=device)


def prepare_post(state_dict: dict, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cpu") -> dict:
    """Pack the generator's conv_post (k7, C -> 1) for folding into the last stage."""
    weight = state_dict["conv_post.weight"].detach()  # (1, C, 7)
    if weight.shape[0] != 1 or weight.shape[2] != _POST_K:
        raise ValueError(f"conv_post must be (1, C, {_POST_K}), got {tuple(weight.shape)}")
    return {
        "w": weight[0].t().contiguous().to(device=device, dtype=dtype),  # (7, C)
        "bias": state_dict["conv_post.bias"].detach().reshape(1).to(device=device, dtype=dtype),
    }


def prepare_upsample(state_dict: dict, stage: int, stride: int, padding: int,
                     dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cpu") -> dict:
    """Pack the upsampler ``ups.{stage}`` (ConvTranspose1d weight (C_in, C_out,
    k), bias) for ``fused_tail_stage(pre_pack=...)``.

    torch's transposed conv writes input row i into output rows
    i * stride - padding + tap. Split by output phase p, output row
    m * stride + p is a dilation-1 conv over the input::

        bias + sum_t lrelu(x[m + offset(p) + t]) @ w[p, t]

    with ``taps`` = ceil(k / stride) taps (t = 0 is the earliest input row;
    a tap past the kernel is zero) and :func:`pre_offset`. ``w`` holds
    (stride, taps, C_in, C_out) in ``dtype``; ``weight`` keeps the torch
    layout for the plain version. The stage then has T_in * stride rows,
    which needs k - 2 * padding == stride (every HiFi-GAN upsampler).
    """
    weight = state_dict[f"ups.{stage}.weight"].detach()
    c_in, c_out, k = (int(v) for v in weight.shape)
    if k - 2 * padding != stride:
        raise ValueError(f"a folded upsampler needs k - 2 * padding == stride, got k={k}, "
                         f"padding={padding}, stride={stride}")
    taps = -(-k // stride)
    poly = torch.zeros((stride, taps, c_in, c_out), dtype=weight.dtype)
    for p in range(stride):
        q = (p + padding) % stride
        for t in range(taps):
            tap = q + (taps - 1 - t) * stride
            if tap < k:
                poly[p, t] = weight[:, :, tap]
    return {
        "w": poly.reshape(-1).to(device=device, dtype=dtype),
        "bias": state_dict[f"ups.{stage}.bias"].detach().reshape(-1).to(device=device,
                                                                       dtype=dtype),
        "weight": weight.to(device=device, dtype=dtype),
        "stride": stride, "k": k, "padding": padding, "taps": taps,
        "c_in": c_in, "channels": c_out,
    }


def pre_offset(pre_pack: dict, phase: int) -> int:
    """Input row of tap 0 for output row m * stride + phase, relative to m."""
    return (phase + pre_pack["padding"]) // pre_pack["stride"] - (pre_pack["taps"] - 1)


def _conv_f32(x: torch.Tensor, kio: torch.Tensor, bias: torch.Tensor, d: int) -> torch.Tensor:
    """'same' conv over (B, C, T) with fp32 accumulation."""
    k = kio.shape[0]
    return F.conv1d(x.float(), kio.float().permute(2, 1, 0), bias.float(),
                    padding=_radius(k, d), dilation=d)


def upsample_reference(x: torch.Tensor, pre_pack: dict) -> torch.Tensor:
    """The folded head alone, plainly: lrelu(0.1), then the transposed conv
    with fp32 accumulation and its bias, rounded to x's dtype once; (B, C,
    T_in * stride)."""
    xin = leaky_relu(x, LRELU_SLOPE).transpose(1, 2).float()
    y = F.conv_transpose1d(xin, pre_pack["weight"].float(), pre_pack["bias"].float(),
                           stride=pre_pack["stride"], padding=pre_pack["padding"])
    return y.to(x.dtype)


def fused_tail_stage_reference(x: torch.Tensor, packed: dict, post_pack: dict | None = None,
                               pre_pack: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_tail_stage`, conv by conv."""
    dtype = x.dtype
    c = packed["channels"]
    xc = x.transpose(1, 2) if pre_pack is None else upsample_reference(x, pre_pack)
    acc = None
    meta = packed["convs"]
    per, ps = packed["convs_per_rb"], packed["pair_size"]
    for rb in range(packed["n_rb"]):
        h = xc
        for p0 in range(0, per, ps):
            t = h
            for j in range(p0, p0 + ps):
                ci = rb * per + j
                k, d, off = meta[ci]
                kio = packed["w"][off:off + k * c * c].view(k, c, c)
                t = _conv_f32(leaky_relu(t, LRELU_SLOPE), kio, packed["bias"][ci], d).to(dtype)
            h = h + t
        acc = h.float() if acc is None else acc + h.float()
    out = (acc / packed["n_rb"]).to(dtype)
    if post_pack is None:
        return out.transpose(1, 2).contiguous()
    wav = _conv_f32(leaky_relu(out, 0.01), post_pack["w"][:, :, None], post_pack["bias"], 1)
    return torch.tanh(wav).transpose(1, 2).contiguous()


# The tensor-core body's geometry, as csrc/resblock_tail.cu has it.
TC_BM = 128          # output rows of a conv tile
TC_STAGES = 3        # cp.async ring of weight chunks
TC_PAD = 8           # bf16 elements of padding per shared-memory row
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
SM_SMEM = 233472  # shared memory of an H100 SM, 1 KB of it reserved per resident block


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tc_tiling(c: int) -> tuple[int, int, int]:
    """(output columns per tile, padded input width, input channels per
    weight chunk) of the tensor-core body for width ``c``."""
    cpad = _round_up(c, 16)
    bn = 32 if c <= 32 else 64 if c <= 64 else 128
    kc = next(k for k in (64, 32, 16) if cpad % k == 0)
    return bn, cpad, kc


def tc_smem(c: int, max_ext: int, pre: dict | None = None) -> int:
    """Shared memory (bytes) of the tensor-core body (``tc_stage_smem`` in the source):
    the operand window of 128 + max_ext rows and the weight ring; with a
    folded upsampler the window also holds 128 + taps - 1 input rows of
    C_in and the ring that phase's chunks."""
    bn, cpad, kc = tc_tiling(c)
    window = (TC_BM + max_ext) * (cpad + TC_PAD)
    if pre is not None:
        _, cpad_in, kc_in = tc_tiling(pre["c_in"])
        window = max(window, (TC_BM + pre["taps"] - 1) * (cpad_in + TC_PAD))
        kc = max(kc, kc_in)
    return _round_up(window, 8) * 2 + TC_STAGES * kc * (bn + TC_PAD) * 2


F32_BM = 128  # output rows of the fp32 body's conv tile (across batch rows)


def f32_bn(c: int) -> int:
    """Output columns of the fp32 body's tile for width ``c`` (``tile_n`` in the source)."""
    return 16 if c <= 16 else 32 if c <= 32 else 64


def f32_convs(packed: dict, batch: int, seq: int, pre: dict | None = None) -> list:
    """The fp32 body's conv tiles as the conv core sees them: (ConvShape,
    channel width) of each conv of the stage and, with ``pre``, of the
    upsampling phase (each output phase a dilation-1 conv of ``taps`` taps
    over the (B, T_in, C_in) input)."""
    c = packed["channels"]
    out = [cs.ConvShape(batch, seq, c, seq, c, k, 1, d, 1, _radius(k, d))
           for k, d, _ in packed["convs"]]
    if pre is not None:
        t_in = seq // pre["stride"]
        out.append(cs.ConvShape(batch, t_in, pre["c_in"], t_in, c, pre["taps"]))
    return out


def f32_smem(shapes: list, kc: int) -> int:
    """Shared memory (bytes) the fp32 body's tiles over ``shapes`` (convs of
    one input width, :func:`f32_convs`) need with reduction chunks of ``kc``
    channels: the most any needs, by the conv core's forward window plan
    (``ops/conv_stack.py::win_plan``; ``f32::stage_smem`` in the source)."""
    bn = f32_bn(shapes[0].c_out)
    return max(cs.win_plan(g, False, torch.float32, F32_BM, bn, kc)["smem"] for g in shapes)


def f32_chunk(shapes: list, limit: int = SMEM_LIMIT) -> int | None:
    """The reduction chunk of the fp32 body's tiles over ``shapes`` (one
    input width): the widest of min(C_in rounded up to 8, 64), 32, 16 and 8
    that every conv takes (the conv core's ``kc_ok``) and whose tiles fit
    ``limit`` bytes of shared memory; None if none does. A wide chunk stages
    fewer windows; a narrower one fits a dilated conv's window across batch
    rows (V3's stage 0 at B > 1) or two blocks an SM."""
    for kc in sorted({min(_round_up(shapes[0].c_in, 8), 64), 32, 16, 8}, reverse=True):
        if all(cs.kc_ok(g, False, torch.float32, kc) for g in shapes) and \
                f32_smem(shapes, kc) <= limit:
            return kc
    return None


def f32_plane(batch: int, seq: int, c: int) -> int:
    """Floats of one fp32 scratch plane: B*T*C rounded up to 16 bytes."""
    return _round_up(batch * seq * c, 4)


def plan_tail_stage(packed: dict, batch: int, seq: int, dtype: torch.dtype, post: bool,
                    sm_count: int, blocks_per_sm, pre: dict | None = None) -> dict:
    """How one stage call runs on the card, decided on the host. ``seq`` is
    the stage's length (T_in * stride with a folded upsampler ``pre``).

    ``blocks_per_sm(channels, smem, f32_minb)`` gives the co-resident
    blocks per SM of the bf16 kernel (``f32_minb`` 0) or of the fp32 one
    compiled for ``f32_minb`` blocks an SM (the card's occupancy query in
    the wrapper). Both bodies run the cooperative schedule (conv by conv
    over the whole sequence). Returns ``body`` ('3xtf32' for fp32,
    'tensor_core' for bf16), ``schedule``, ``tile`` (the conv tile's rows),
    ``bn`` (its columns), ``kc`` (input channels per weight chunk; fp32: per
    reduction chunk, ``kc_in`` the upsampling phase's, ``minb`` the blocks
    an SM its kernel is compiled for), ``grid``, ``smem`` (bytes), ``items``
    (work items of the busiest phase) and ``scratch`` (elements of device
    scratch: activation planes, with ``pre`` one more for the upsampled x;
    fp32 also a plane of lrelu(x), two activated planes a resblock and,
    with ``pre``, the lrelu'd input).
    """
    c = packed["channels"]
    if pre is not None and (pre["channels"] != c or seq % pre["stride"]):
        raise ValueError(f"pre_pack gives {pre['channels']} channels at stride {pre['stride']}; "
                         f"the stage has {c} channels and {seq} rows")
    if dtype == torch.float32:
        bn = f32_bn(c)
        n_tiles = -(-c // bn)
        items = packed["n_rb"] * -(-batch * seq // F32_BM) * n_tiles
        planes = 1 + 3 * packed["n_rb"] + (1 if post else 0)
        scratch = planes * f32_plane(batch, seq, c)
        if pre is not None:
            t_in = seq // pre["stride"]
            items = max(items, pre["stride"] * -(-batch * t_in // F32_BM) * n_tiles)
            scratch += f32_plane(batch, seq, c) + batch * t_in * pre["c_in"]
        shapes = f32_convs(packed, batch, seq, pre)
        mrf, up = shapes[:len(packed["convs"])], shapes[len(packed["convs"]):]
        # two blocks an SM where the busiest phase has two tiles for each SM
        # and a chunk fits both blocks' shared memory, else one
        for minb in (2, 1) if items >= 2 * sm_count else (1,):
            limit = SMEM_LIMIT if minb == 1 else SM_SMEM // 2 - 1024
            kc = f32_chunk(mrf, limit)
            kc_in = f32_chunk(up, limit) if up else 0
            if kc is not None and kc_in is not None:
                break
        else:
            raise ValueError(f"the fp32 body cannot take the convs of {shapes[0]} in "
                             f"{SMEM_LIMIT} bytes of shared memory")
        smem = max(f32_smem(mrf, kc), f32_smem(up, kc_in) if up else 0)
        grid = min(items, blocks_per_sm(c, smem, minb) * sm_count)
        return {"body": "3xtf32", "schedule": "cooperative", "tile": F32_BM, "bn": bn, "kc": kc,
                "kc_in": kc_in, "minb": minb, "grid": grid, "smem": smem, "items": items,
                "scratch": scratch}
    if c % 8 or (pre is not None and pre["c_in"] % 8):
        raise ValueError(f"the bf16 body takes widths that are multiples of 8, got {c}"
                         + ("" if pre is None else f" from {pre['c_in']}"))
    max_ext = max((k - 1) * d for k, d, _ in packed["convs"])
    smem = tc_smem(c, max_ext, pre)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the bf16 body needs {smem} bytes of shared memory at C={c}, more "
                         f"than {SMEM_LIMIT}")
    bn = tc_tiling(c)[0]
    n_tiles = -(-c // bn)
    items = packed["n_rb"] * batch * -(-seq // TC_BM) * n_tiles
    if pre is not None:  # the upsampling phase: one item per output phase and input tile
        items = max(items, pre["stride"] * batch * -(-(seq // pre["stride"]) // TC_BM) * n_tiles)
    grid = min(items, blocks_per_sm(c, smem, 0) * sm_count)
    planes = 2 * packed["n_rb"] + (1 if post else 0) + (1 if pre is not None else 0)
    return {"body": "tensor_core", "schedule": "cooperative", "tile": TC_BM, "bn": bn,
            "kc": tc_tiling(c)[2], "grid": grid, "smem": smem, "items": items,
            "scratch": planes * batch * seq * c}


_KERNELS = None  # the ctypes entries of csrc/resblock_tail.cu, their signatures set once


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("resblock_tail")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f32 = lib.hifigan_mrf_stage_f32
        f32.restype = ci
        f32.argtypes = [vp] * 4 + [ctypes.POINTER(ci)] + [vp] * 6 + [ci] * 15 + [vp]
        tc = lib.hifigan_mrf_stage_tc
        tc.restype = ci
        tc.argtypes = [vp] * 10 + [ci] * 13 + [vp]
        occ = lib.hifigan_mrf_blocks_per_sm
        occ.restype = ci
        occ.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        _KERNELS = {"f32": f32, "tc": tc, "occupancy": occ}
    return _KERNELS


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, c: int, smem: int, f32_minb: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _kernels()["occupancy"](f32_minb, c, smem, ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"fused_tail_stage: occupancy query failed (cudaError {rc}, "
                           f"{out.value} blocks per SM at {smem} bytes of shared memory)")
    return out.value


def _check(x: torch.Tensor, packed: dict, post_pack: dict | None,
           pre_pack: dict | None) -> None:
    c_x = packed["channels"] if pre_pack is None else pre_pack["c_in"]
    if x.dim() != 3 or x.shape[2] != c_x:
        raise ValueError(f"x must be (B, T, {c_x}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    tensors = [packed["w"], packed["bias"]]
    for extra in (post_pack, pre_pack):
        if extra is not None:
            tensors += [extra["w"], extra["bias"]]
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("packed weights must be contiguous, on x's device, in x's dtype")
    if post_pack is not None and tuple(post_pack["w"].shape) != (_POST_K, packed["channels"]):
        raise ValueError(f"post_pack weights must be ({_POST_K}, {packed['channels']})")
    if pre_pack is not None and pre_pack["channels"] != packed["channels"]:
        raise ValueError(f"pre_pack gives {pre_pack['channels']} channels, the stage has "
                         f"{packed['channels']}")
    if packed["desc"].device != x.device:
        raise ValueError("packed descriptors must be on x's device")


@functools.lru_cache(maxsize=256)
def _desc_host(convs: tuple) -> ctypes.Array:
    """A host copy of the packed descriptors (k, dilation, offset per conv)."""
    return (ctypes.c_int * (3 * len(convs)))(*(v for conv in convs for v in conv))


def fused_tail_stage(x: torch.Tensor, packed: dict, post_pack: dict | None = None,
                     pre_pack: dict | None = None) -> torch.Tensor:
    """x (B, T, C) -> the stage's MRF output (B, T, C), or (B, T, 1) float32 with post_pack.

    With ``pre_pack`` x is the previous stage's output (B, T_in, C_in) and
    the stage's leaky ReLU and upsampler run first, in the same launch; then
    T = T_in * stride. A CPU tensor takes :func:`fused_tail_stage_reference`;
    a CUDA tensor launches the kernel (or raises).
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_tail_stage_reference(x, packed, post_pack, pre_pack)
    if x.device.type != "cuda":
        raise ValueError(f"fused_tail_stage runs on cpu or cuda, got {x.device}")
    _check(x, packed, post_pack, pre_pack)
    kernels = _kernels()
    b, t_in, _ = x.shape
    c = packed["channels"]
    stride = 1 if pre_pack is None else pre_pack["stride"]
    t = t_in * stride
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = plan_tail_stage(packed, b, t, x.dtype, post_pack is not None, _sm_count(dev),
                           functools.partial(_blocks_per_sm, dev), pre=pre_pack)
    if post_pack is not None:
        y = torch.empty((b, t, 1), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((b, t, c), dtype=x.dtype, device=x.device)

    def ptr(pack, key):
        return pack[key].data_ptr() if pack is not None else None

    if pre_pack is not None:
        pre = (pre_pack["c_in"], stride, pre_pack["taps"], pre_pack["padding"])
    else:
        pre = (0, 1, 0, 0)
    scratch = torch.empty(plan["scratch"], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan["body"] == "3xtf32":
            rc = kernels["f32"](
                x.data_ptr(), packed["w"].data_ptr(), packed["bias"].data_ptr(),
                packed["desc"].data_ptr(), _desc_host(tuple(packed["convs"])),
                ptr(post_pack, "w"), ptr(post_pack, "bias"), ptr(pre_pack, "w"),
                ptr(pre_pack, "bias"), y.data_ptr(), scratch.data_ptr(), b, t, c,
                packed["n_rb"], packed["convs_per_rb"], packed["pair_size"], plan["kc"],
                plan["minb"], plan["grid"], plan["smem"], pre[0], plan["kc_in"], *pre[1:],
                stream)
        else:
            max_ext = max((k - 1) * d for k, d, _ in packed["convs"])
            rc = kernels["tc"](
                x.data_ptr(), packed["w"].data_ptr(), packed["bias"].data_ptr(),
                packed["desc"].data_ptr(), ptr(post_pack, "w"), ptr(post_pack, "bias"),
                ptr(pre_pack, "w"), ptr(pre_pack, "bias"), y.data_ptr(), scratch.data_ptr(), b,
                t, c, packed["n_rb"], packed["convs_per_rb"], packed["pair_size"], max_ext,
                plan["grid"], plan["smem"], *pre, stream)
    if rc != 0:
        raise RuntimeError(f"fused_tail_stage kernel launch failed ({plan['body']} body): "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return y
