"""Data-parallel training in the port on spawned gloo ranks, against one
process on the same global batch: a dp = 2 train step (loss within 1e-6
relative, gradients within 1e-5 of each tensor's max|g|, the updated
parameters and Adam moments), a distillation step and a DnCNN step (its
BatchNorms on the global batch's statistics); the trainer with
configs/flagship_sigma25.yaml at ``data_parallel: 2`` through the CLI as
``torchrun`` starts it and the tiny flagship at ``tensor_parallel: 2``,
each checkpointed by rank 0 and resumed
by a one-process trainer with the parameters and data position of a
one-process run; the refusal of the tiny pixel and ablation models, whose
placement JAX refuses at tp = 2;
``broadcast_params``; JAX's "auto" rule; the loader's and the latent
noise's slices."""

from __future__ import annotations

import os
import socket

import numpy as np
import pytest
import torch

from irdu_tpu_torch.data.dataset import PatchDataset
from irdu_tpu_torch.data.loader import batched_loader
from irdu_tpu_torch.data.synthetic import write_synthetic_corpus
from irdu_tpu_torch.train.checkpoints import CheckpointManager
from irdu_tpu_torch.train.steps import draw_latent_noise
from irdu_tpu_torch.train.trainer import Trainer, resolve_parallel
from irdu_tpu_torch.utils.config import apply_overrides, load_config

import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_corpus"))
    return root, write_synthetic_corpus(root, n_images=4, size_range=(70, 100), seed=7)


FLAGSHIP_CONFIG = os.path.join(REPO, "configs", "flagship_sigma25.yaml")


def flagship_overrides(corpus, data_parallel):
    """``-s`` overrides of configs/flagship_sigma25.yaml (full width): the
    tiny corpus, one stage of 16² crops at global batch 2, one step, no
    periodic eval, a log line a step."""
    root, csv_path = corpus
    return [f"datasets.train.csv_path={csv_path}", f"datasets.train.root_folder={root}",
            "train.stages=[{patch_size: 16, batch_size: 2, max_num_patchs: 20}]",
            "train.max_steps=1", "train.eval_rate=0", "train.verbose_rate=1",
            f"parallel.data_parallel={data_parallel}"]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """(every rank's results of ``train_job`` on 2 ranks, its workdir): the
    workdir holds the trainer's run at tp = 2 under "tp" and, under "dp",
    ``python -m irdu_tpu_torch.train --config configs/flagship_sigma25.yaml``
    with ``data_parallel: 2`` (one step) as ``torchrun --nproc_per_node 2``
    starts it."""
    work = str(tmp_path_factory.mktemp("dp_work"))
    argv = ["--config", FLAGSHIP_CONFIG] + [a for o in flagship_overrides(corpus, 2)
                                           for a in ("-s", o)]
    with socket.socket() as sock:  # a free port of localhost for the env:// rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    res = ranks.spawn(ranks.train_job, 2, str(tmp_path_factory.mktemp("dp_spawn")), corpus,
                      work, argv, port)
    return res, work


def _reference(kind):
    noisy, clean = ranks.global_batch()
    if kind == "batchnorm":
        return ranks.one_step(ranks.tiny_dncnn(), noisy, clean, aux=False)
    return ranks.one_step(ranks.tiny_flagship(), noisy, clean,
                          teacher=ranks.tiny_flagship(seed=1).requires_grad_(False)
                          if kind == "distill" else None)


@pytest.mark.parametrize("kind", ["step", "distill", "batchnorm"])
def test_dp_step_equals_one_process(runs, kind):
    """Bars: the loss 1e-6 relative; each gradient within 1e-5 of its
    tensor's max|g| (two ranks' means averaged against one mean: reduction
    order only; a conv bias before a BatchNorm, whose gradient is zero and
    reads as rounding noise, within 1e-5 of the model's largest gradient);
    after one Adam step of lr 1e-3, which moves a parameter by lr·g/(|g| +
    1e-8), the parameters within 1e-7 where |g| > 1e-6 and within 2·lr
    where g is near 0 and its gap swings that quotient; the moments within
    1e-5 (m = 0.1 g) and 3e-5 (v = 0.001 g²: twice g's relative gap) of
    each tensor's max."""
    ref = _reference(kind)
    # a conv's bias before a BatchNorm: zero gradient in exact arithmetic
    zero = {f"{owner}.bias" for owner, mod in ranks.tiny_dncnn().named_modules()
            if getattr(mod, "bn", None) is not None} if kind == "batchnorm" else set()
    for rank, res in enumerate(runs[0]):
        got = res[kind]
        assert abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"]), (rank, got["loss"])
        assert abs(got["psnr"] - ref["psnr"]) <= 1e-4
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        for n, g in ref["grads"].items():
            if n in zero:  # both sides rounding noise
                assert float(got["grads"][n].abs().max()) <= 1e-5 * top, (rank, n)
                continue
            scale = max(float(g.abs().max()), 1e-12)
            assert float((got["grads"][n] - g).abs().max()) <= 1e-5 * scale, (rank, n)
            gap = (got["params"][n] - ref["params"][n]).abs()
            assert float(torch.where(g.abs() > 1e-6, gap, 0.0).max()) <= 1e-7, (rank, n)
            assert float(gap.max()) <= 2e-3, (rank, n)
            for k, (a, b) in enumerate(zip(got["moments"][n], ref["moments"][n])):
                bar = (1e-5, 3e-5)[k] * max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= bar, (rank, n, k)


def _one_process_config(corpus, kind):
    """The configuration of each run, with ``data_parallel: auto``: for "dp"
    configs/flagship_sigma25.yaml's, for "tp" the tiny one."""
    if kind == "dp":
        return apply_overrides(load_config(FLAGSHIP_CONFIG), flagship_overrides(corpus, "auto"))
    return ranks.trainer_config(corpus, {"data_parallel": "auto"}, 2)


@pytest.mark.parametrize("kind,steps", [("dp", 1), ("tp", 2)])
def test_trainer_checkpoint_resumes_in_one_process(runs, corpus, tmp_path, kind, steps):
    """The trainer on 2 ranks (flagship_sigma25 at dp = 2 through the CLI as
    torchrun starts it, or the tiny flagship at tp = 2) ran ``steps`` steps
    and rank 0 wrote one checkpoint at the last and the log; a one-process
    trainer on that workdir restores it, and its parameters and data
    position are a one-process run's of the same steps (Adam's updates from
    gradients equal to reduction order: 1e-6)."""
    res, work = runs
    for r in res:
        if kind == "tp":
            assert r[kind]["result"] == {"step": steps} and r[kind]["world"] == 2
            assert (r[kind]["dp"], r[kind]["tp"]) == (1, 2)
        else:
            assert r["cli"] == {"step": steps}
    wd = os.path.join(work, kind)
    if kind == "dp":
        log = open(os.path.join(wd, "train.log")).read()
        assert "mesh: data_parallel=2 tensor_parallel=1" in log and "iter=1 " in log
    assert sorted(os.listdir(os.path.join(wd, "checkpoints"))) == [str(steps)]
    one_process = Trainer(_one_process_config(corpus, kind), workdir=str(tmp_path),
                          device="cpu")
    one_process.run()
    resumed = Trainer(_one_process_config(corpus, kind), workdir=wd, device="cpu")
    assert resumed.state.step == steps
    assert resumed.data_state == {"epoch": 0, "stage": 0, "offset": steps}
    got = dict(resumed.model.named_parameters())
    for n, p in one_process.model.named_parameters():
        np.testing.assert_allclose(got[n].detach().numpy(), p.detach().numpy(), atol=1e-6,
                                   err_msg=n)
    for p, q in zip(resumed.state.optimizer.state.values(),
                    one_process.state.optimizer.state.values()):
        np.testing.assert_allclose(p["exp_avg"].numpy(), q["exp_avg"].numpy(), atol=1e-6)


def test_tp_trainer_held_half_of_each_split_tensor(runs):
    shapes = runs[0][0]["tp"]["local_shapes"]
    full = dict(ranks.tiny_flagship().named_parameters())
    w = "encoder_scale_00_0.local_linear.channels_linear_op.weight"
    assert shapes[w][0] * 2 == full[w].shape[0]


def test_broadcast_params_replicates_rank_0(runs):
    want = ranks.tiny_flagship(seed=0).state_dict()
    for r in runs[0]:
        for n, t in want.items():
            assert torch.equal(r["broadcast"][n], t), n


@pytest.mark.parametrize("name", ["pixel", "ablation"])
def test_tp_refuses_models_it_cannot_split(runs, name):
    """The tiny pixel model (``project_out`` sizes 21 and 85) and the
    one-graph ablation (G = 1) at tp = 2: JAX's placement is uneven, and the
    trainer refuses it with JAX's reason before any step."""
    for r in runs[0]:
        msg = r["refused"][name]
        assert msg and "uneven placement" in msg and "% tp 2" in msg, msg


@pytest.mark.parametrize("parallel,world,want", [
    ({"data_parallel": "auto"}, 4, (4, 1)),
    ({}, 2, (2, 1)),
    ({"data_parallel": "auto", "tensor_parallel": 2}, 4, (2, 2)),
    ({"data_parallel": 2, "tensor_parallel": 2}, 4, (2, 2)),
    ({"data_parallel": 2}, 4, None),
    ({"tensor_parallel": 3}, 4, None),
    ({"data_parallel": "auto", "tensor_parallel": 8}, 4, None),
])
def test_parallel_section_resolves_by_jax_rule(parallel, world, want):
    if want is None:
        with pytest.raises(ValueError, match=f"the run has {world}"):
            resolve_parallel(parallel, world)
    else:
        assert resolve_parallel(parallel, world) == want


def test_loader_slices_stack_to_the_global_batch(corpus):
    root, csv_path = corpus
    ds = PatchDataset(csv_path=csv_path, root_folder=root, patch_size=(16, 16),
                      max_num_patchs=12, seed=3)
    whole = list(batched_loader(ds, 4, backend="python", skip_batches=1))
    parts = [list(batched_loader(ds, 4, backend="python", skip_batches=1, shard=(i, 2)))
             for i in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for k, (noisy, clean) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[k][0] for p in parts]), noisy)
        np.testing.assert_array_equal(np.concatenate([p[k][1] for p in parts]), clean)
    with pytest.raises(ValueError, match="does not divide"):
        next(batched_loader(ds, 3, shard=(0, 2)))


def test_latent_noise_slices_stack_to_the_global_draw():
    codes = [torch.zeros(4, 8, 6, 6), torch.zeros(4, 12, 3, 3)]
    whole = draw_latent_noise(codes, torch.Generator().manual_seed(5))
    halves = [draw_latent_noise([c[:2] for c in codes], torch.Generator().manual_seed(5),
                                (i, 2)) for i in range(2)]
    for s, w in enumerate(whole):
        assert torch.equal(torch.cat([h[s] for h in halves]), w)


def test_checkpoint_of_one_process_is_written_as_before(tmp_path):
    """Without a mesh, ``save`` writes and returns True, and False for a
    step already on disk."""
    from irdu_tpu_torch.train.steps import create_train_state

    state = create_train_state(torch.nn.Linear(2, 2), lambda s: 1e-3)
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.save(1, state, {"offset": 1}) and not mngr.save(1, state)


def test_tp_snapshot_loads_in_jax_and_in_one_process(runs, corpus, tmp_path):
    """The tp = 2 run's checkpoint, restored in one process and written as a
    JAX snapshot (``params_from_torch``, ``save_params_npz``), reads back
    through JAX's ``load_params_npz`` as the one-process model's tree, leaf
    for leaf, and loads into a one-process port model unchanged."""
    from irdu_tpu.utils.weights import load_params_npz as jax_load
    from irdu_tpu_torch.utils.weights import (load_params_npz, params_from_torch,
                                              params_to_torch, save_params_npz)

    resumed = Trainer(ranks.trainer_config(corpus, {"data_parallel": "auto"}, 2),
                      workdir=os.path.join(runs[1], "tp"), device="cpu")
    path = str(tmp_path / "tp_snapshot.npz")
    tree = params_from_torch(resumed.model)
    save_params_npz(path, tree)

    def flat(node, prefix=()):
        for k, v in node.items():
            yield from flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    theirs = dict(flat(jax_load(path)))
    mine = dict(flat(tree))
    assert theirs.keys() == mine.keys()
    for key, arr in mine.items():
        np.testing.assert_array_equal(np.asarray(theirs[key]), arr, err_msg=str(key))
    one = ranks.tiny_flagship(seed=9)
    params_to_torch(load_params_npz(path), one)
    got = dict(one.named_parameters())
    for n, p in resumed.model.named_parameters():
        assert torch.equal(got[n], p), n
