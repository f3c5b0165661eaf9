"""The port's trainer on the CPU, at a tiny size: run and auto-resume (the
params of a resumed run without aux losses are a straight run's, bitwise;
with them, the restored state and the batches are, and the latent noise
restarts from the seed as JAX's key does), the logs and the periodic eval,
a finished run, the per-stage remat override, distillation, the checkpoint
directory's rules, the refusal of a degree the run lacks and the CLI; the "auto" loader's
native batches train to the thread pool's params, bitwise."""

from __future__ import annotations

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import irdu_tpu_torch.train.trainer as trainer_module
from irdu_tpu_torch.data.dataset import PatchDataset
from irdu_tpu_torch.data.synthetic import write_synthetic_corpus
from irdu_tpu_torch.models.registry import create_model
from irdu_tpu_torch.train.checkpoints import CheckpointManager
from irdu_tpu_torch.train.steps import create_train_state
from irdu_tpu_torch.train.trainer import Trainer
from irdu_tpu_torch.utils.weights import params_from_torch, save_params_npz


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them about as fast,
    and the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"type": "abstract_multiscale_graph_filter", "dims": [8, 12, 16, 24],
        "hidden_dims": [16, 24, 32, 48], "ngraphs": [2, 2, 4, 4], "num_blocks": [1, 1, 1, 1],
        "num_blocks_out": 1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_corpus"))
    return root, write_synthetic_corpus(root, n_images=4, size_range=(70, 100), seed=7)


def _config(corpus, max_steps=4, **train):
    root, csv_path = corpus
    conf = {
        "name": "tiny_port", "manual_seed": 7, "model": dict(TINY),
        "parallel": {"data_parallel": "auto"},
        "datasets": {"train": {"csv_path": csv_path, "root_folder": root,
                               "dist_mode": "addictive_noise_scale", "lambda_noise": 25.0,
                               "use_data_aug": True, "seed": 2204}},
        "train": {"num_epochs": 1,
                  "stages": [{"patch_size": 16, "batch_size": 2, "max_num_patchs": 20}],
                  "schedule": {"type": "constant", "base_lr": 1e-3}, "use_aux_losses": True,
                  "verbose_rate": 1, "checkpoint_rate": 2, "eval_rate": 0,
                  "max_steps": max_steps},
    }
    conf["train"].update(train)
    return conf


class Recording(Trainer):
    """Records each step's batch and the generator's state before it."""

    def _train_step_for(self, remat):
        step = super()._train_step_for(remat)
        self.batches = []

        def recorded(state, noisy, clean, gen):
            self.batches.append((noisy.clone(), clean.clone(), gen.get_state()))
            return step(state, noisy, clean, gen)

        return recorded


def _params(trainer):
    return [p.detach().clone() for p in trainer.model.parameters()]


def _moments(trainer):
    return [st[k].clone() for st in trainer.state.optimizer.state.values()
            for k in ("exp_avg", "exp_avg_sq")]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_resume_without_aux_losses_is_a_straight_run(corpus, tmp_path):
    """With no latent draws the resumed run's params equal a straight run's,
    bitwise: the state and the data position come back exactly."""
    def conf(n):
        return _config(corpus, max_steps=n, use_aux_losses=False)

    Trainer(conf(2), workdir=str(tmp_path / "resumed"), device="cpu").run()
    resumed = Trainer(conf(4), workdir=str(tmp_path / "resumed"), device="cpu")
    assert resumed.state.step == 2 and resumed.data_state == {"epoch": 0, "stage": 0, "offset": 2}
    assert resumed.run() == {"step": 4}
    straight = Trainer(conf(4), workdir=str(tmp_path / "straight"), device="cpu")
    straight.run()
    assert _equal(_params(resumed), _params(straight))
    assert _equal(_moments(resumed), _moments(straight))


def test_resume_with_aux_losses_restores_state_batches_not_noise(corpus, tmp_path):
    """With the aux losses on: the restored params and Adam moments are the
    saved ones bitwise, the batches after the resume are a straight run's,
    and the latent noise generator restarts from the seed (JAX's key does the
    same), so from the resume on the draws differ from a straight run's."""
    first = Recording(_config(corpus, max_steps=2), workdir=str(tmp_path / "r"), device="cpu")
    first.run()
    saved, saved_moments = _params(first), _moments(first)
    resumed = Recording(_config(corpus, max_steps=4), workdir=str(tmp_path / "r"), device="cpu")
    assert _equal(saved, _params(resumed)) and _equal(saved_moments, _moments(resumed))
    resumed.run()
    straight = Recording(_config(corpus, max_steps=4), workdir=str(tmp_path / "s"),
                         device="cpu")
    straight.run()
    for (n, c, g), (sn, sc, sg) in zip(resumed.batches, straight.batches[2:]):
        assert torch.equal(n, sn) and torch.equal(c, sc)
    assert torch.equal(resumed.batches[0][2], straight.batches[0][2])  # the seed's state
    assert not torch.equal(resumed.batches[0][2], straight.batches[2][2])
    assert len(resumed.batches) == 2


def test_logs_and_periodic_eval(corpus, tmp_path):
    """JAX's line formats in train.log, the eval protocol at eval_rate on the
    images ``_eval_images`` hands over, the model's kernels switched back off
    after it."""
    class Evaluating(Trainer):
        def _eval_images(self, spec):
            rs = np.random.RandomState(0)
            return [(rs.rand(40, 48, 3) * 255).astype(np.uint8) for _ in range(2)]

    conf = _config(corpus, max_steps=2, eval_rate=2, checkpoint_rate=0)
    conf["name"] = "tiny_port_eval"
    conf["eval"] = {"sigma": 25.0, "datasets": {"tiny_set": {}}}
    trainer = Evaluating(conf, workdir=str(tmp_path), device="cpu")
    trainer.run()
    assert not trainer.model.use_kernels
    log = open(os.path.join(str(tmp_path), "train.log")).read()
    assert "iter=1 time=" in log and "iter=2 time=" in log and " psnr=" in log
    assert "FINISH VAL step=2 dataset=tiny_set psnr_testing=" in log
    assert np.isfinite(trainer.run_eval()["tiny_set"])


def test_finished_run_resumes_to_nothing(corpus, tmp_path):
    """A run through all its data saves epoch == num_epochs; a resume then
    takes no step and returns the same step."""
    conf = _config(corpus, max_steps=None, checkpoint_rate=0, use_aux_losses=False)
    conf["train"]["stages"][0]["max_num_patchs"] = 6
    assert Trainer(conf, workdir=str(tmp_path), device="cpu").run() == {"step": 3}
    again = Trainer(conf, workdir=str(tmp_path), device="cpu")
    assert again.data_state == {"epoch": 1, "stage": 0, "offset": 0}
    before = _params(again)
    assert again.run() == {"step": 3}
    assert _equal(before, _params(again))


def test_stage_remat_override_flips_the_switch(corpus, tmp_path):
    """A stage's ``remat`` flips the model's switch (no rebuild; None keeps
    the configured value) and trains to the same params (on the CPU the
    recomputation is the same arithmetic)."""
    out = []
    for remat in (True, False):
        conf = _config(corpus, max_steps=2, checkpoint_rate=0, use_aux_losses=False)
        conf["train"]["stages"][0]["remat"] = remat
        trainer = Trainer(conf, workdir=str(tmp_path / str(remat)), device="cpu")
        model = trainer.model
        trainer.run()
        assert trainer.model is model and model.remat is remat
        trainer._train_step_for(None)
        assert model.remat is False
        out.append(_params(trainer))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_distillation_trainer_freezes_a_teacher_on_its_kernels(corpus, tmp_path):
    """``train.distill``: the teacher from an npz snapshot in its dtype, frozen,
    its kernels on (their plain versions on the CPU) and the student's off;
    the student trains."""
    torch.manual_seed(1)
    teacher_kw = {k: v for k, v in TINY.items() if k != "type"}
    path = str(tmp_path / "teacher.npz")
    save_params_npz(path, params_from_torch(create_model(TINY["type"], **teacher_kw)))
    conf = _config(corpus, max_steps=2, checkpoint_rate=0)
    conf["model"]["remat"] = True
    conf["train"]["distill"] = {"model": dict(TINY, use_pallas_blocks=True,
                                              use_pallas_solver=True),
                                "weights": path, "weight": 1.0, "dtype": "float32"}
    trainer = Trainer(conf, workdir=str(tmp_path / "wd"), device="cpu")
    teacher = trainer.teacher
    before = [p.clone() for p in teacher.parameters()]
    student = _params(trainer)
    trainer.run()
    assert teacher.use_kernels and not trainer.model.use_kernels and trainer.model.remat
    assert not any(p.requires_grad for p in teacher.parameters())
    assert _equal(before, list(teacher.parameters()))
    assert not _equal(student, _params(trainer))


def test_checkpoint_directory_rules(tmp_path):
    """max_to_keep keeps the newest; a directory whose name ends in a step's
    digits is that step's; a step on disk is not written again; a temporary
    directory is no step; a checkpoint without data.json restores with no
    data state."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, lambda k: 1e-3)
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        assert mngr.save(step, state, {"offset": step})
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    assert not mngr.save(3, state)
    os.rename(tmp_path / "3", tmp_path / "ckpt_000007")
    os.remove(tmp_path / "ckpt_000007" / "data.json")
    os.makedirs(tmp_path / "8.tmp")
    assert mngr.latest_step() == 7
    with torch.no_grad():
        model.weight.zero_()
    state, data = mngr.restore(state)
    assert data is None and state.step == 3 and model.weight.abs().max() > 0
    state, data = mngr.restore(state, step=2)
    assert data == {"offset": 2} and state.step == 2


def test_multi_device_config_is_refused(corpus, tmp_path):
    """A data-parallel degree the process group does not have (here one
    process, no group) is refused before anything is built."""
    conf = _config(corpus)
    conf["parallel"] = {"data_parallel": 4}
    with pytest.raises(ValueError, match="needs 4 ranks; the run has 1"):
        Trainer(conf, workdir=str(tmp_path), device="cpu")


def test_cli_trains_two_steps_on_the_cpu(corpus, tmp_path):
    """``python -m irdu_tpu_torch.train --config x.yaml --device cpu -s ...``
    in a subprocess: two steps, a checkpoint, the log."""
    conf = copy.deepcopy(_config(corpus, max_steps=50))
    conf["name"] = "tiny_port_cli"
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(conf))
    wd = tmp_path / "wd"
    proc = subprocess.run(
        [sys.executable, "-m", "irdu_tpu_torch.train", "--config", str(path), "--device", "cpu",
         "--workdir", str(wd), "-s", "train.max_steps=2", "-s", "train.use_aux_losses=false"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.isdir(wd / "checkpoints" / "2")
    log = (wd / "train.log").read_text()
    assert "iter=2 time=" in log and "Init model with total parameters:" in log


class Counted(PatchDataset):
    """Counts the items each path assembles (``calls``, per class)."""

    calls: dict = {}

    def get_batch(self, indices, num_threads=0):
        type(self).calls["native"] = type(self).calls.get("native", 0) + len(indices)
        return super().get_batch(indices, num_threads)

    def __getitem__(self, idx):
        type(self).calls["python"] = type(self).calls.get("python", 0) + 1
        return super().__getitem__(idx)


class PythonOnly(Counted):
    calls: dict = {}

    def native_compatible(self):
        return False


def test_native_batches_train_as_the_thread_pool(corpus, tmp_path, monkeypatch):
    """The trainer's "auto" loader takes the native path on its PNG corpus:
    3 steps give the params, bitwise, of 3 steps on a dataset that reports
    ``native_compatible() == False`` (the thread pool), and 2 native steps
    resumed mid-stage to 3 give them too."""
    def run(cls, workdir, n):
        monkeypatch.setattr(trainer_module, "PatchDataset", cls)
        trainer = Trainer(_config(corpus, max_steps=n, use_aux_losses=False),
                          workdir=str(tmp_path / workdir), device="cpu")
        trainer.run()
        return trainer

    native = run(Counted, "native", 3)
    python = run(PythonOnly, "python", 3)
    assert Counted.calls.get("native", 0) >= 6 and "python" not in Counted.calls
    assert PythonOnly.calls.get("python", 0) >= 6 and "native" not in PythonOnly.calls
    assert _equal(_params(native), _params(python))
    assert _equal(_moments(native), _moments(python))
    run(Counted, "resumed", 2)
    resumed = run(Counted, "resumed", 3)
    assert resumed.data_state == {"epoch": 0, "stage": 0, "offset": 2}
    assert _equal(_params(resumed), _params(native))
