"""Rank bodies of the port's multi-rank CPU tests (``test_torch_parallel_*``):
gloo ranks spawned with a ``file://`` rendezvous, one thread each. Each job
runs the same code on every rank and returns a picklable result per rank.
This module imports torch and the port only, never JAX: the spawned ranks
import it."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

# test_parallel_sp.py's TINY flagship (irdu_tpu), as keywords of the port's class
# (test_parallel_tp.py's tiny model has its widths with two blocks a list)
SP_TINY = dict(n_channels_in=3, n_channels_out=3, dims=(8, 12, 16, 24),
               hidden_dims=(16, 24, 32, 48), nsubnets=(1, 1, 1, 1), ngraphs=(2, 2, 4, 4),
               num_blocks=(1, 1, 1, 1), num_blocks_out=1)
# tests/test_spatial_windows.py's sizes of the identity check
IDENTITY_SIZES = ((40, 144), (48, 144), (64, 40), (24, 24), (112, 144), (96, 96))
HALO_SHAPES = ((256, 48), (250, 41))
HALO = 16


def _entry(rank, world, init_file, out_dir, fn, args):
    from irdu_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=world, init_method=f"file://{init_file}")
    try:
        torch.save(fn(rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, out_dir: str, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; each rank's
    result, in rank order. A rank that raises fails the call. The ranks fork
    from a fresh server process that has imported torch and this module
    once (the forkserver; the test process, which has JAX's threads, is
    never forked)."""
    mp.set_forkserver_preload([__name__])
    mp.start_processes(_entry, args=(world, os.path.join(out_dir, "rendezvous"), out_dir, fn,
                                     args), nprocs=world, start_method="forkserver")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def sub_mesh(members, dp, tp):
    """A dp × tp mesh over the world's ranks ``members``, so that one spawn
    serves two mesh sizes: every rank calls it (``new_group`` asks that);
    None on the ranks outside."""
    from irdu_tpu_torch.parallel.mesh import Mesh

    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(tp):
        g = dist.new_group([members[d * tp + m] for d in range(dp)])
        data_group = g if rank in members[m::tp] else data_group
    for d in range(dp):
        g = dist.new_group(members[d * tp:(d + 1) * tp])
        model_group = g if rank in members[d * tp:(d + 1) * tp] else model_group
    if rank not in members:
        return None
    return Mesh(dp, tp, members.index(rank), torch.device("cpu"), data_group, model_group)


def seeded_image(h, w, seed):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def identity(x):
    return x * 1.0


def mean3(x):
    """3×3 box filter, edge-padded (test_spatial_windows.py's)."""
    p = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    return F.avg_pool2d(p, 3, stride=1).permute(0, 2, 3, 1)


def toy_stencil(x):
    """A 5×5 box filter, edge-padded, plus 0.1·x²: 2 pixels of receptive
    field."""
    p = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
    return F.avg_pool2d(p, 5, stride=1).permute(0, 2, 3, 1) + 0.1 * x * x


def tiny_flagship(seed=0, **kw):
    from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
    from irdu_tpu_torch.models.registry import set_kernels

    torch.manual_seed(seed)
    model = AbstractMultiScaleGraphFilter(**{**SP_TINY, **kw})
    set_kernels(model, False)
    return model


def tiny_dncnn(seed=0):
    """A 3-channel DnCNN with BatchNorms, 8 wide, 3 layers."""
    from irdu_tpu_torch.baselines.drunet import DnCNN

    torch.manual_seed(seed)
    return DnCNN(in_nc=3, out_nc=3, nc=8, nb=3)


def spatial_job(rank, world):
    """Every spatial check, on 4 ranks and on ranks {0, 1}: the toy stencil
    and the TINY flagship through ``halo_shard_forward``; on the 2 ranks
    also the identity and the mean-3 stencil through
    ``sharded_tiled_forward``. {mesh size: results}; rank 0's are those of
    both meshes."""
    from irdu_tpu_torch.parallel.mesh import make_mesh
    from irdu_tpu_torch.parallel.spatial import halo_shard_forward, sharded_tiled_forward
    from irdu_tpu_torch.predict import batch_forward

    out = {}
    for mesh in (make_mesh(torch.device("cpu")), sub_mesh([0, 1], 2, 1)):
        if mesh is None:
            continue
        res = out[mesh.dp] = {"halo_toy": {}, "halo_tiny": {}}
        if mesh.dp == 2:
            res["identity"] = {hw: sharded_tiled_forward(identity, seeded_image(*hw, 0), mesh,
                                                         tile=32, halo=32)
                               for hw in IDENTITY_SIZES}
            res["mean3"] = sharded_tiled_forward(mean3, seeded_image(48, 112, 1), mesh,
                                                 tile=32, halo=32)
        for k, hw in enumerate(HALO_SHAPES):
            res["halo_toy"][hw] = halo_shard_forward(toy_stencil, seeded_image(*hw, 2 + k),
                                                     mesh, halo=HALO)
            res["halo_tiny"][hw] = halo_shard_forward(batch_forward(tiny_flagship()),
                                                      seeded_image(*hw, 4 + k), mesh, halo=HALO)
    return out


def global_batch(n=4, side=32, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.rand(n, side, side, 3).astype(np.float32)),
            torch.from_numpy(rs.rand(n, side, side, 3).astype(np.float32)))


def one_step(model, noisy, clean, mesh=None, teacher=None, seed=3, aux=True):
    """One train step (lr 1e-3, the generator seeded ``seed``; ``aux``: the
    flagship's two latent terms) of ``model`` on ``mesh`` (None: one
    process) on a global batch: this rank's (loss, grads, params, Adam
    moments), each tensor in the single-device layout."""
    from irdu_tpu_torch.parallel.mesh import shard_batch
    from irdu_tpu_torch.parallel.tensor import (gather_full, gather_train_state, model_shard,
                                                param_shardings)
    from irdu_tpu_torch.train.steps import (create_train_state, distribute,
                                            make_distill_train_step, make_train_step)

    state = create_train_state(model, lambda s: 1e-3)
    step = (make_distill_train_step(teacher, use_aux_losses=aux) if teacher is not None
            else make_train_step(use_aux_losses=aux))
    if mesh is not None:
        distribute(state, mesh)
        noisy, clean = shard_batch((noisy, clean), mesh)
    state, m = step(state, noisy, clean, torch.Generator().manual_seed(seed))
    grads = {}
    placements = param_shardings(model)
    for n, p in model.named_parameters():
        pl = placements[n]
        with torch.no_grad():
            grads[n] = (gather_full(p.grad, pl, model_shard(mesh)) if mesh is not None
                        and mesh.tp > 1 and pl is not None else p.grad).clone()
    params, opt = gather_train_state(state, mesh)
    names = [n for n, _ in model.named_parameters()]
    moments = {names[i]: (st["exp_avg"], st["exp_avg_sq"]) for i, st in opt["state"].items()}
    return dict(loss=float(m["loss"]), psnr=float(m["psnr"]), grads=grads,
                params={n: t.clone() for n, t in params.items()}, moments=moments)


def tensor_job(rank, world, variants):
    """One step of SP_TINY per conv variant on the 2 × 2 mesh of 4 ranks, and
    of the plain one on the 1 × 2 mesh of ranks {0, 1}, with the shapes of
    the slices each rank holds: {(mesh size, tp): {variant: results}}."""
    from irdu_tpu_torch.parallel.tensor import make_dp_tp_mesh

    noisy, clean = global_batch()
    out = {}
    for mesh in (make_dp_tp_mesh(2, torch.device("cpu")), sub_mesh([0, 1], 1, 2)):
        if mesh is None:
            continue
        res = out[(mesh.size, mesh.tp)] = {}
        for variant in variants if mesh.dp > 1 else variants[:1]:
            model = tiny_flagship(conv_variant=variant)
            res[variant] = one_step(model, noisy, clean, mesh)
            res[variant]["local_shapes"] = {n: tuple(p.shape)
                                            for n, p in model.named_parameters()}
    return out


def mesh_job(rank, world, variants):
    """``spatial_job`` and ``tensor_job`` in one spawn of 4 ranks."""
    return {"spatial": spatial_job(rank, world), "tensor": tensor_job(rank, world, variants)}


def train_job(rank, world, corpus, workdir, cli_argv, port):
    """dp = 2: a train step, a distillation step and a BatchNorm model's step
    against one process' (returned for the caller to compare), the trainer with
    ``tensor_parallel: 2`` (2 steps, checkpointed by rank 0), rank 0's
    parameters broadcast over rank 1's, and the trainer's refusal of the
    tiny pixel and ablation models, whose placement JAX refuses at tp = 2; then, the spawn's group left, the CLI's
    ``main(cli_argv)`` on the CPU as ``torchrun`` starts it on each rank
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set, the
    env:// rendezvous on ``port`` of localhost), into ``workdir``/dp."""
    from irdu_tpu_torch.parallel.mesh import broadcast_params, make_mesh
    from irdu_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(torch.device("cpu"))
    noisy, clean = global_batch()
    out = {"step": one_step(tiny_flagship(), noisy, clean, mesh),
           "distill": one_step(tiny_flagship(), noisy, clean, mesh,
                               teacher=tiny_flagship(seed=1).requires_grad_(False)),
           "batchnorm": one_step(tiny_dncnn(), noisy, clean, mesh, aux=False)}
    tr = Trainer(trainer_config(corpus, {"data_parallel": "auto", "tensor_parallel": 2}, 2),
                 workdir=os.path.join(workdir, "tp"), device="cpu")
    out["tp"] = dict(result=tr.run(), world=tr.mesh.size, dp=tr.mesh.dp, tp=tr.mesh.tp,
                     local_shapes={n: tuple(p.shape) for n, p in tr.model.named_parameters()})
    model = tiny_flagship(seed=rank)
    broadcast_params(model)
    out["broadcast"] = {n: t.clone() for n, t in model.state_dict().items()}
    out["refused"] = {}
    for name, model in (("pixel", PIXEL_TINY), ("ablation", ABLATION_TINY)):
        conf = trainer_config(corpus, {"tensor_parallel": 2}, 1)
        conf["model"] = dict(model)
        try:
            Trainer(conf, workdir=os.path.join(workdir, f"refused_{name}"), device="cpu")
            out["refused"][name] = None
        except ValueError as exc:
            out["refused"][name] = str(exc)
    from irdu_tpu_torch.train.__main__ import main

    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    out["cli"] = main(cli_argv + ["--device", "cpu", "--workdir", os.path.join(workdir, "dp")])
    return out


TRAIN_TINY = {"type": "abstract_multiscale_graph_filter", "dims": [8, 12, 16, 24],
              "hidden_dims": [16, 24, 32, 48], "ngraphs": [2, 2, 4, 4],
              "num_blocks": [1, 1, 1, 1], "num_blocks_out": 1}
PIXEL_TINY = {"type": "multiscale_sequence_denoiser", "n_graphs": 2, "n_cnn_fts": 8,
              "feature_num_blocks": [1, 1, 1, 1], "feature_num_refinement": 1}
ABLATION_TINY = {"type": "one_graph_filter"}


def trainer_config(corpus, parallel, max_steps):
    """test_torch_train_trainer.py's tiny configuration with ``parallel``,
    a global batch of 2 and a checkpoint at ``max_steps``."""
    root, csv_path = corpus
    return {
        "name": "tiny_parallel", "manual_seed": 7, "model": dict(TRAIN_TINY),
        "parallel": dict(parallel),
        "datasets": {"train": {"csv_path": csv_path, "root_folder": root,
                               "dist_mode": "addictive_noise_scale", "lambda_noise": 25.0,
                               "use_data_aug": True, "seed": 2204}},
        "train": {"num_epochs": 1,
                  "stages": [{"patch_size": 16, "batch_size": 2, "max_num_patchs": 20}],
                  "schedule": {"type": "constant", "base_lr": 1e-3}, "use_aux_losses": True,
                  "verbose_rate": 1, "checkpoint_rate": 0, "eval_rate": 0,
                  "max_steps": max_steps},
    }


# the models of the tp = 2 steps of tests/test_torch_parallel_models.py:
# (registry name, keywords, whether the flagship's latent terms are in the loss)
TP_MODELS = {
    "ablation": ("multiscale_graph_filter", dict(ngraphs=4), False),
    "dncnn": ("dncnn", dict(in_nc=3, out_nc=3, nc=8, nb=3), False),
    "flagship_subnets": ("abstract_multiscale_graph_filter",
                         {**SP_TINY, "nsubnets": (2, 2, 1, 1)}, True),
    "restormer": ("restormer", dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                    heads=(1, 1, 1, 1), ffn_expansion_factor=2.0), False),
}


def tp_model(kind, seed=0):
    """A seeded model of ``TP_MODELS`` on its kernels' plain versions."""
    from irdu_tpu_torch.models.registry import create_model, set_kernels

    name, kw, _ = TP_MODELS[kind]
    torch.manual_seed(seed)
    model = create_model(name, **kw)
    set_kernels(model, False)
    return model


def models_job(rank, world):
    """One step of each ``TP_MODELS`` model at tp = 2 (dp = 1) on the 2
    ranks: {kind: this rank's results, the shapes of the slices it holds}."""
    from irdu_tpu_torch.parallel.tensor import make_dp_tp_mesh

    mesh = make_dp_tp_mesh(2, torch.device("cpu"))
    noisy, clean = global_batch()
    out = {}
    for kind in TP_MODELS:
        model = tp_model(kind)
        out[kind] = one_step(model, noisy, clean, mesh, aux=TP_MODELS[kind][2])
        out[kind]["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return out
