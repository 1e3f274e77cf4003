"""gloo ranks for the port's parallel tests: the work each rank does.

It imports torch and the port only (no JAX): the ranks are spawned
processes, and the JAX references are computed by the test process.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from hifigan_tpu_torch.parallel.mesh import initialize_distributed


def start_ranks(work, n: int, tmp, inputs: dict):
    """Spawn ``n`` gloo ranks, each running ``work(rank, n, inputs)``; returns
    a handle for :func:`join_ranks` (the caller works meanwhile)."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    return torch.multiprocessing.start_processes(_rank_main, args=(work, n, str(tmp)), nprocs=n,
                                                 join=False, start_method="spawn")


def join_ranks(ctx, n: int, tmp, timeout: float = 300.0) -> list:
    """Each rank's result, in rank order; raises if a rank fails or the
    ranks outlive ``timeout`` seconds (they are killed then)."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} gloo ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


def _rank_main(rank: int, work, n: int, tmp: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{tmp}/store", world_size=n, rank=rank,
                           local_rank=rank, timeout=datetime.timedelta(seconds=240))
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = work(rank, n, inputs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree


def state_dicts(state) -> dict:
    return {name: _numpy(getattr(state, name).state_dict())
            for name in ("generator", "mpd", "msd")}


def v1_work(rank: int, n: int, inp: dict) -> dict:
    """Mesh, TP rule, halo exchange, sharded generator, the TP x DP V1 step,
    the DP step under ``msd_conv_impl='fused_zoned'`` and ``disc_fused`` and
    the conv stack's batch-sharded form, on 4 ranks."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.ops.conv_stack import fused_conv_stack
    from hifigan_tpu_torch.parallel.halo import halo_exchange, make_sharded_generator
    from hifigan_tpu_torch.parallel.mesh import (
        create_mesh,
        reduce_gradients,
        row_block,
        shard_batch,
        tensor_parallel_shardings,
    )
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    h = inp["h"]
    out: dict = {}
    mesh = create_mesh(model=2, device="cpu")
    out["shape"] = dict(mesh.shape)
    state = create_train_state(h, seed=0, device="cpu", mesh=mesh)
    shardings = tensor_parallel_shardings(state, mesh, min_size=8)
    out["shardings"] = shardings

    x = torch.from_numpy(inp["halo_x"])
    t_loc = x.shape[1] // n
    window, offset = halo_exchange(x[:, rank * t_loc:(rank + 1) * t_loc].contiguous(),
                                   inp["halo"], None)
    out["window"], out["offset"] = window.numpy(), int(offset)

    dmesh = create_mesh(model=1, device="cpu")
    gen_sd = {k: torch.from_numpy(v) for k, v in inp["gen_sd"].items()}
    out["wav"] = make_sharded_generator(h, dmesh, folded=False)(
        gen_sd, torch.from_numpy(inp["mel"])).numpy()

    step = make_train_step(h, mesh=mesh, state_shardings=shardings)
    audio = inp["audio"][row_block(len(inp["audio"]), mesh.shape["data"],
                                   mesh.coordinate("data"))]
    state, metrics = step(state, shard_batch({"audio": audio}, mesh))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["after"] = state_dicts(state)
    names = {id(p): f"{top}.{k}" for top in ("generator", "mpd", "msd")
             for k, p in getattr(state, top).named_parameters()}
    moments = {**state.opt_g.state, **state.opt_d.state}
    out["held"] = {names[id(p)]: (tuple(s.shape), tuple(moments[s]["exp_avg"].shape))
                   for p, s, _ in state.shards}

    # the DP step under the zoned MSD and disc_fused (the rank's rows, twice over)
    forms = AttrDict(inp["forms_h"])
    fstate = create_train_state(forms, seed=0, device="cpu", mesh=dmesh)
    fstate, fm = make_train_step(forms, mesh=dmesh)(fstate, shard_batch(
        {"audio": inp["audio"][row_block(len(inp["audio"]), n, dmesh.coordinate("data"))]},
        dmesh))
    out["forms_metrics"] = {k: float(v) for k, v in fm.items()}
    out["forms_after"] = state_dicts(fstate)

    specs, ks, bs = inp["stack"]
    ks = [torch.from_numpy(k).requires_grad_() for k in ks]
    bs = [torch.from_numpy(b).requires_grad_() for b in bs]
    ys = fused_conv_stack(torch.from_numpy(inp["stack_x"]), ks, bs, specs, mesh=dmesh)
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(ys, inp["stack_cot"])).backward()
    reduce_gradients(ks + bs, dmesh)
    out["stack_ys"] = [y.detach().numpy() for y in ys]
    out["stack_grads"] = [p.grad.numpy() for p in ks + bs]
    return out


def distill_models(inp: dict, mesh=None, member_impl: str = "auto"):
    """The tiny distillation models carrying the JAX variables, with a noise
    node after the decoder when ``inp['noise']``."""
    from hifigan_tpu_torch.distill.model import DistillModels
    from hifigan_tpu_torch.dsl.normalize import SEQ, normalize_config
    from hifigan_tpu_torch.train.checkpoint import (
        distill_variables_from_jax,
        load_distill_variables,
    )

    cfg, labels, weights = inp["cfg"]
    models = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                           member_impl=member_impl, device="cpu", mesh=mesh)
    if inp.get("noise"):  # one more step at the end: the other nodes keep their paths
        seq, steps = models.decoder.config
        assert seq == SEQ
        models.decoder.config = (SEQ, (*steps, normalize_config(("res", ("noise", 1)))))
    models.build(cfg["loops"]["train"]["segment_length"])
    load_distill_variables(models, distill_variables_from_jax(inp["variables"]))
    return models


def distill_step(inp: dict, mesh=None, batch=None, member_impl: str = "auto"):
    """One distillation step: (losses, variables after, B3 calls)."""
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.ops import stream_graph
    from hifigan_tpu_torch.train.checkpoint import distill_state_dicts, distill_variables_to_jax

    models = distill_models(inp, mesh, member_impl)
    trainer = DistillTrainer(models, inp["cfg"][0])
    state = trainer.create_state(build=False)
    calls = stream_graph.CALLS
    state, losses = trainer.make_train_step(mesh=mesh)(
        state, inp["batch"] if batch is None else batch,
        torch.Generator().manual_seed(inp["seed"]))
    return (_numpy(losses), distill_variables_to_jax(distill_state_dicts(models)),
            stream_graph.CALLS - calls)


def distill_work(rank: int, n: int, inp: dict) -> dict:
    """The DP distill step on ``n`` ranks (without and with a noise node)."""
    from hifigan_tpu_torch.parallel.mesh import create_mesh, row_block

    mesh = create_mesh(device="cpu")
    block = row_block(len(inp["batch"]["audio"]), n, mesh.coordinate("data"))

    def rows(x):
        return {k: rows(v) for k, v in x.items()} if isinstance(x, dict) else x[block]

    out = {}
    for case in ("plain", "noise"):
        case_inp = {**inp, "noise": case == "noise"}
        losses, after, calls = distill_step(case_inp, mesh, rows(inp["batch"]))
        out[case] = {"losses": losses, "after": after if rank == 0 else None, "calls": calls}
    return out


def record_reads(cls, key: str) -> list:
    """Wrap ``cls.batches`` in this process: the rows (``batch[key]``) each
    shuffled call yields, one list a call (an epoch)."""
    reads, orig = [], cls.batches

    def batches(self, *args, **kw):
        if not kw.get("shuffle", True):
            yield from orig(self, *args, **kw)
            return
        reads.append([])
        for batch in orig(self, *args, **kw):
            reads[-1].extend(batch[key])
            yield batch

    cls.batches = batches
    return reads


def cli_train_work(rank: int, n: int, inp: dict) -> dict:
    """``cli/train.py`` as under torchrun (``WORLD_SIZE`` > 1)."""
    from hifigan_tpu_torch.cli import train as cli_train
    from hifigan_tpu_torch.data.meldataset import MelDataset

    reads = record_reads(MelDataset, "filenames")
    os.environ.update(WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank))
    state = cli_train.main(inp["argv"])
    return {"step": state.step, "generator": _numpy(state.generator.state_dict()),
            "reads": reads}


def distill_main_work(rank: int, n: int, inp: dict) -> dict:
    """``distill.main.train`` on every rank with ``mesh='auto'``."""
    from hifigan_tpu_torch.data.multilabel import MultilabelWaveDataset
    from hifigan_tpu_torch.distill import main as tmain
    from tests.test_torch_data_engine import port_dataset

    reads = record_reads(MultilabelWaveDataset, "paths")
    datasets = {k: port_dataset(inp["corpus"], cache_dir=inp["cache"], deterministic=True)
                for k in ("train", "validation")}
    state = tmain.train(inp["config"], datasets, logs_base=inp["logs"], max_steps=2,
                        device="cpu", mesh="auto")
    return {"step": None if state is None else state.step, "reads": reads}
