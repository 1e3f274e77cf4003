"""Guards of the PyTorch port: what it imports, where it runs, no fallback."""

import ast
import inspect
import os
import textwrap

import pytest
import torch

from hifigan_tpu_torch.cli import infer
from hifigan_tpu_torch.cli import train as cli_train
from hifigan_tpu_torch.models import DiscriminatorS, MultiScaleDiscriminator
from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
from hifigan_tpu_torch.models.streaming import make_streaming_vocoder
from hifigan_tpu_torch.ops import conv_stack as tstack
from hifigan_tpu_torch.ops import logmel as tlogmel
from hifigan_tpu_torch.ops import msd_conv as tmsd
from hifigan_tpu_torch.ops import resblock_tail as ttail
from hifigan_tpu_torch.ops import stream_graph as tsg
from hifigan_tpu_torch.parallel import halo as thalo
from hifigan_tpu_torch.train.vocoder import create_train_state
from tests.torch_port_helpers import folded_pair, small_config, tiny_train_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# yaml, msgpack and pandas: the port reads and writes the JAX side's YAML
# and msgpack itself and builds its corpus table without pandas, so it
# needs none of them (chip_smoke.py phase 17 prints which the card has)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hifigan_tpu", "yaml", "msgpack", "pandas")


def _port_files():
    root = os.path.join(REPO, "hifigan_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _imports_by_name(path):
    """The module named in every ``import_module(...)`` or ``__import__(...)``
    call; a name that is not a string literal comes out as ``None``."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else None
        if name in ("import_module", "__import__"):
            arg = node.args[0] if node.args else None
            literal = isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            yield arg.value if literal else None


def test_port_imports_no_forbidden_module_by_name():
    """``importlib.import_module`` and ``__import__`` run a module as an
    import statement does, out of the scan above's sight: in the port and
    in ``chip_smoke.py`` they name a literal module, never a forbidden one
    (probe a module's presence with ``importlib.util.find_spec``)."""
    bad = [(os.path.relpath(f, REPO), m) for f in _port_files() for m in _imports_by_name(f)
           if m is None or m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_by_name_scan_sees_a_probe_loop(tmp_path):
    """The scan flags a name passed through a variable, as a probe loop
    over module names does."""
    probe = tmp_path / "probe.py"
    probe.write_text("import importlib\nfor m in ('pandas', 'scipy'):\n"
                     "    importlib.import_module(m)\n__import__('yaml')\n"
                     "importlib.import_module('json')\n")
    assert sorted(_imports_by_name(str(probe)), key=str) == [None, "json", "yaml"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """An AST scan: the environment may import jax at interpreter start-up,
    so sys.modules proves nothing."""
    files = list(_port_files())
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"hifigan_tpu_torch/ops/conv_stack.py", "hifigan_tpu_torch/models/discriminators.py",
            "hifigan_tpu_torch/train/vocoder.py", "hifigan_tpu_torch/cli/train.py",
            "hifigan_tpu_torch/data/meldataset.py", "hifigan_tpu_torch/ops/stream_graph.py",
            "hifigan_tpu_torch/dsl/module.py", "hifigan_tpu_torch/dsl/fused_member.py",
            "hifigan_tpu_torch/dsl/static_configs.py", "hifigan_tpu_torch/distill/train.py",
            "hifigan_tpu_torch/distill/model.py", "hifigan_tpu_torch/distill/losses.py",
            "hifigan_tpu_torch/ops/msd_conv.py", "hifigan_tpu_torch/ops/logmel.py",
            "hifigan_tpu_torch/audio/mel.py", "hifigan_tpu_torch/models/layers.py",
            "hifigan_tpu_torch/models/streaming.py", "hifigan_tpu_torch/parallel/halo.py",
            "hifigan_tpu_torch/parallel/__init__.py", "hifigan_tpu_torch/dsl/stream_fusion.py",
            "hifigan_tpu_torch/train/msgpack.py", "hifigan_tpu_torch/utils/caching.py",
            "hifigan_tpu_torch/utils/pytree.py", "hifigan_tpu_torch/distill/sniffer.py",
            "hifigan_tpu_torch/cli/infer_autoencoding.py", "hifigan_tpu_torch/data/native.py",
            "hifigan_tpu_torch/data/codecs.py", "hifigan_tpu_torch/data/augmentation.py",
            "hifigan_tpu_torch/data/complex_parser.py", "hifigan_tpu_torch/data/textgrid.py",
            "hifigan_tpu_torch/data/multilabel.py", "hifigan_tpu_torch/callbacks/base.py",
            "hifigan_tpu_torch/callbacks/logging.py", "hifigan_tpu_torch/callbacks/checkpoints.py",
            "hifigan_tpu_torch/callbacks/visualization.py", "hifigan_tpu_torch/utils/plotting.py",
            "hifigan_tpu_torch/distill/main.py", "hifigan_tpu_torch/cli/train_sniffers.py",
            "hifigan_tpu_torch/cli/warm_cache.py", "hifigan_tpu_torch/parallel/mesh.py",
            "hifigan_tpu_torch/graft_entry.py", "hifigan_tpu_torch/utils/runtime.py",
            "hifigan_tpu_torch/utils/debug.py", "hifigan_tpu_torch/callbacks/valves.py",
            "hifigan_tpu_torch/data/wave_dataset.py"} <= rel
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_matplotlib_only_inside_the_plotting_functions():
    """The card's machine has no matplotlib: only ``utils/plotting.py``
    imports it, and only inside its functions, so every module imports
    there."""
    plotting = os.path.join(REPO, "hifigan_tpu_torch", "utils", "plotting.py")
    users = [os.path.relpath(f, REPO) for f in _port_files()
             if any(m.split(".")[0] == "matplotlib" for m in _imported_modules(f))]
    assert users == ["hifigan_tpu_torch/utils/plotting.py"]
    tree = ast.parse(open(plotting, encoding="utf-8").read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("matplotlib" in ast.dump(n) for n in top)
    funcs = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    inside = [n for f in funcs for n in ast.walk(f) if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert inside and all("matplotlib" in ast.dump(n) for n in inside)


def test_entry_points_without_device_raise_when_there_is_no_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = small_config("1")
    _, sd = folded_pair(h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fast_vocoder(h, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_streaming_vocoder(h, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.inference(infer.build_parser().parse_args(
            ["--checkpoint_file", str(tmp_path / "g_00000000")]), h)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    h = small_config("1")
    _, sd = folded_pair(h)
    packed = ttail.pack_generator_tail(h, sd, 1)
    calls = []
    monkeypatch.setattr(ttail, "fused_tail_stage_reference",
                        lambda x, p, post_pack=None, pre_pack=None: calls.append(x.device) or x)
    launches = ttail.LAUNCHES
    ttail.fused_tail_stage(torch.zeros(1, 16, 8), packed)
    assert calls == [torch.device("cpu")] and ttail.LAUNCHES == launches
    with pytest.raises(ValueError):
        ttail.fused_tail_stage(torch.zeros(1, 16, 8, device="meta"), packed)
    assert len(calls) == 1


def test_wrapper_has_no_fallback():
    """The CUDA branch launches or raises: no try/except in the wrapper."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ttail.fused_tail_stage)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("fn", [make_fast_vocoder, make_streaming_vocoder,
                                thalo.streaming_vocode, infer.synthesize])
def test_serving_paths_have_no_fallback(fn):
    """The fast, the stateful and the halo serving paths and the CLI's
    choice among them catch nothing around a launch."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_training_entry_points_without_device_raise_when_there_is_no_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = tiny_train_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--config", str(tmp_path / "config.json")])
    assert create_train_state(h, device="cpu").device == torch.device("cpu")


def test_conv_stack_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    specs = [tstack.LayerSpec(8, 3, 1, 1, 1, 1, 0.1)]
    calls = []
    monkeypatch.setattr(tstack, "fused_conv_stack_reference",
                        lambda x, k, b, s, weight_grads=True: calls.append(x.device) or [x])
    before = tstack.launches()
    tstack.fused_conv_stack(torch.zeros(1, 16, 8), [torch.zeros(3, 8, 8)], [None], specs)
    assert calls == [torch.device("cpu")] and tstack.launches() == before
    with pytest.raises(ValueError):
        tstack.fused_conv_stack(torch.zeros(1, 16, 8, device="meta"), [torch.zeros(3, 8, 8)],
                                [None], specs)
    assert len(calls) == 1


@pytest.mark.parametrize("fn", [tstack.fused_conv_stack, tstack._FusedConvStack.forward,
                                tstack._FusedConvStack.backward, tstack.zone_grouped_layer,
                                tstack.fold_group_zones, tstack.unfold_group_zones,
                                DiscriminatorS.forward, DiscriminatorS.zone_chain,
                                DiscriminatorS._zone_run, DiscriminatorS._std_run,
                                DiscriminatorS._stack])
def test_conv_stack_wrapper_has_no_fallback(fn):
    """The CUDA branch launches or raises: no try/except around a launch."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _tiny_segment():
    seg = tsg.Segment(levels=(tsg.Level(8, 1, True), tsg.Level(8, 2)),
                      ops=(tsg.Op(1, (tsg.Edge(0, 1, 3, 1, 1, 1),), "lrelu", 0.1),))
    return seg, [torch.zeros(3, 1, 2)], [None]


def test_stream_graph_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    seg, tables, biases = _tiny_segment()
    calls = []
    monkeypatch.setattr(tsg, "fused_stream_graph_reference",
                        lambda seg, x, t, b, members=1, weight_grads=True:
                        calls.append(x[0].device) or [x[0]])
    before = tsg.launches()
    tsg.fused_stream_graph(seg, [torch.zeros(1, 8, 1)], tables, biases)
    assert calls == [torch.device("cpu")] and tsg.launches() == before
    with pytest.raises(ValueError):
        tsg.fused_stream_graph(seg, [torch.zeros(1, 8, 1, device="meta")], tables, biases)
    assert len(calls) == 1


@pytest.mark.parametrize("fn", [tsg.fused_stream_graph, tsg._StreamGraph.forward,
                                tsg._StreamGraph.backward, tsg._forward_cuda,
                                tsg._backward_cuda])
def test_stream_graph_wrapper_has_no_fallback(fn):
    """The CUDA branch launches or raises: no try/except around a launch."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_stream_graph_rejects_what_the_kernels_do_not_take():
    bad = tsg.Segment(levels=(tsg.Level(8, 1, True), tsg.Level(8, 2)),
                      ops=(tsg.Op(1, (tsg.Edge(0, 1, 3, 2, 2, 1),)),))
    with pytest.raises(ValueError, match="stride and dilation"):
        tsg.check_segment(bad)
    order = tsg.Segment(levels=(tsg.Level(8, 1, True), tsg.Level(8, 2), tsg.Level(8, 2)),
                        ops=(tsg.Op(2, (tsg.Edge(0, 1, 3, 1, 1, 1),)),
                             tsg.Op(1, (tsg.Edge(0, 1, 3, 1, 1, 1),))))
    with pytest.raises(ValueError, match="level order"):
        tsg.check_segment(order)


def test_distill_entry_points_without_device_raise_when_there_is_no_gpu(monkeypatch, tmp_path):
    from __graft_entry__ import _tiny_distill_config
    from hifigan_tpu_torch.cli import train_sniffers
    from hifigan_tpu_torch.distill import main as distill_main
    from hifigan_tpu_torch.distill.model import DistillModels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, labels, weights = _tiny_distill_config(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistillModels(cfg, labels, weights)
    assert DistillModels(cfg, labels, weights, device="cpu").device == torch.device("cpu")
    ds = type("D", (), {"label_options_groups": labels, "label_weights_groups": weights})()
    cfg = dict(cfg, experiment={"name": "x", "version": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distill_main.initialize(cfg, {"train": ds}, logs_base=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_sniffers.train_sniffers({}, {"train": ds}, str(tmp_path))
    for entry in (distill_main.main, train_sniffers.main):
        parser_default = [a for a in ast.walk(ast.parse(inspect.getsource(entry)))
                          if isinstance(a, ast.Call) and getattr(a.func, "attr", "") ==
                          "add_argument" and ast.literal_eval(a.args[0]) == "--device"]
        assert len(parser_default) == 1
        kw = {k.arg: ast.literal_eval(k.value) for k in parser_default[0].keywords}
        assert kw["default"] == "cuda"


def test_msd_conv_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(tmsd, "msd_conv1d_lrelu_reference",
                        lambda x, k, b, **kw: calls.append(x.device) or x)
    before = tmsd.launches()
    tmsd.msd_conv1d_lrelu(torch.zeros(1, 16, 8), torch.zeros(3, 8, 8), None, padding=1)
    assert calls == [torch.device("cpu")] and tmsd.launches() == before
    with pytest.raises(ValueError):
        tmsd.msd_conv1d_lrelu(torch.zeros(1, 16, 8, device="meta"), torch.zeros(3, 8, 8), None)
    assert len(calls) == 1


def test_log_mel_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    from hifigan_tpu_torch.audio.mel import MelConfig

    calls = []
    monkeypatch.setattr(tlogmel, "fused_log_mel_reference",
                        lambda y, cfg: calls.append(y.device) or y)
    launches = tlogmel.LAUNCHES
    tlogmel.fused_log_mel(torch.zeros(1, 4096), MelConfig())
    assert calls == [torch.device("cpu")] and tlogmel.LAUNCHES == launches
    with pytest.raises(ValueError):
        tlogmel.fused_log_mel(torch.zeros(1, 4096, device="meta"), MelConfig())
    assert len(calls) == 1


@pytest.mark.parametrize("fn", [tmsd.msd_conv1d_lrelu, tmsd._MsdConv.forward,
                                tmsd._MsdConv.backward, tmsd._launch_fwd, tmsd._launch_dx,
                                tlogmel.fused_log_mel, tlogmel._FusedLogMel.forward,
                                tlogmel._FusedLogMel.backward, tlogmel._launch])
def test_msd_conv_and_log_mel_wrappers_have_no_fallback(fn):
    """The CUDA branch launches or raises: no try/except around a launch."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_the_tpu_lane_layout_still_raises():
    """The zone form runs (the TPU lane layout is ported), and still raises,
    as the JAX package asserts, where a width is not a multiple of 128: its
    groups could not fill 128 lanes."""
    for build in (lambda: DiscriminatorS(width=16, conv_impl="fused_zoned"),
                  lambda: MultiScaleDiscriminator(width=16, conv_impl="fused_zoned")):
        with pytest.raises(ValueError, match="fused_zoned"):
            build()
    logits, _ = DiscriminatorS(width=128, conv_impl="fused_zoned")(torch.zeros(1, 64))
    assert logits.shape[0] == 1
    msd = MultiScaleDiscriminator(width=128, num_scales=1, conv_impl="fused_zoned")
    y_d_rs, y_d_gs, _, _ = msd(torch.zeros(1, 64), torch.zeros(1, 64))
    assert len(y_d_rs) == len(y_d_gs) == 1


@pytest.mark.parametrize("t,masked", [(512, False), (257, True)])
def test_zoned_path_reaches_the_conv_stack_and_has_no_fallback(monkeypatch, t, masked):
    """``'fused_zoned'`` sends the zone chain (layers 2-5) to
    ``fused_conv_stack`` as one call of banded layers, their lane masks set
    where a length does not divide the fold, and the other layers as
    standard runs; a tensor on another device reaches the wrapper too, which
    raises: the path never falls back."""
    from hifigan_tpu_torch.models import discriminators as tdisc

    calls = []
    real = tdisc.fused_conv_stack
    monkeypatch.setattr(tdisc, "fused_conv_stack", lambda xs, k, b, specs, **kw: calls.append(
        (xs[0].device, tuple(specs))) or real(xs, k, b, specs, **kw))
    d = DiscriminatorS(width=128, conv_impl="fused_zoned")
    before = tstack.launches()
    d(torch.zeros(2, t))
    assert tstack.launches() == before
    assert [len(specs) for _, specs in calls] == [1, 4, 2]
    assert all(dev == torch.device("cpu") for dev, _ in calls)
    zone = calls[1][1]
    assert all(sp.groups == 16 and sp.c_out == 2048 for sp in zone)
    assert [sp.kernel for sp in zone] == [5, 8, 12, 21] and [sp.stride for sp in zone] == [1, 2, 2, 1]
    assert any(sp.lane_period for sp in zone) == masked
    d.to("meta")
    with pytest.raises(ValueError, match="fused_conv_stack runs on cpu or cuda"):
        d(torch.zeros(2, t, device="meta"))


def test_stream_fusion_reaches_the_stream_graph_and_has_no_fallback(monkeypatch):
    """``stream_impl='fused'`` sends each fused run to ``fused_stream_graph``
    (its plain version for CPU tensors); a tensor on another device reaches
    the wrapper too, which raises: the pass never falls back to the
    interpreter."""
    from hifigan_tpu_torch.dsl import fused_member
    from hifigan_tpu_torch.dsl import stream_fusion as sf
    from hifigan_tpu_torch.dsl.module import ConfigurableModule

    cfg = [("conv", (2, 4, 3)), ("lrelu", 0.1), ("res", [("conv", (4, 4, 3))]), ("tanh",)]
    x = torch.zeros(1, 16, 2)
    m = ConfigurableModule(cfg, stream_impl="fused").build(x)
    calls = []
    real = fused_member.fused_stream_graph
    monkeypatch.setattr(fused_member, "fused_stream_graph",
                        lambda seg, ins, *a, **kw: calls.append(ins[0].device) or real(
                            seg, ins, *a, **kw))
    before = tsg.launches()
    m(x)
    assert calls == [torch.device("cpu")] and tsg.launches() == before
    m.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        m(torch.zeros(1, 16, 2, device="meta"))
    assert len(calls) == 2
    for fn in (sf.run_fused, sf.eval_stream_fused, fused_member._SegBuilder.run):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _backend_from_availability(path):
    """Each ``init_process_group`` call whose backend is computed from
    ``torch.cuda.is_available``: its backend argument, or a name that
    argument uses and the enclosing function assigns, mentions
    ``is_available``."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    hits = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            continue
        assigned = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name):
                            assigned.setdefault(name.id, []).append(node.value)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and "init_process_group" in ast.dump(node.func)):
                continue
            backend = node.args[:1] + [k.value for k in node.keywords if k.arg == "backend"]
            exprs = list(backend)
            for e in backend:
                exprs += [v for n in ast.walk(e) if isinstance(n, ast.Name)
                          for v in assigned.get(n.id, [])]
            if any("is_available" in ast.dump(e) for e in exprs):
                hits.append(node.lineno)
    return sorted(set(hits))  # a call inside a function is seen from the module too


def test_no_process_group_backend_follows_what_is_available():
    """The backend follows the requested device (nccl for cuda, gloo for
    cpu), never ``torch.cuda.is_available()``."""
    bad = [(os.path.relpath(f, REPO), line) for f in _port_files()
           for line in _backend_from_availability(f)]
    assert not bad, bad


def test_backend_scan_sees_an_availability_switch(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import torch\nimport torch.distributed as dist\n"
                     "def a():\n    b = 'nccl' if torch.cuda.is_available() else 'gloo'\n"
                     "    dist.init_process_group(b)\n"
                     "def c():\n    dist.init_process_group(backend='gloo')\n")
    assert _backend_from_availability(str(probe)) == [5]


def test_parallel_entry_points_need_their_gpus(monkeypatch):
    from hifigan_tpu_torch import graft_entry
    from hifigan_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="cuda:0 is not available"):
        mesh.initialize_distributed("cuda", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    assert not torch.distributed.is_initialized()
