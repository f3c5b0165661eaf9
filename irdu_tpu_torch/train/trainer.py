"""The config-driven trainer (counterpart: ``irdu_tpu/train/trainer.py``),
with JAX's loop: progressive patch-size stages chained per epoch, rolling
PSNR logs every ``verbose_rate`` steps, checkpoints every
``checkpoint_rate`` steps with auto-resume (the data position too), the eval
protocol every ``eval_rate`` steps, ``max_steps`` to stop early.

Parallelism (``parallel: {data_parallel, tensor_parallel}``, JAX's rules,
``resolve_parallel``): the ranks of the default process group (``torchrun
--nproc_per_node N``; ``parallel.mesh.init_distributed`` joins it) form a
dp × tp mesh; each rank trains on its slice of every global batch
(``data.loader.batched_loader(shard=)``), the student wrapped in DDP over
the data group, and under tp > 1 placed over the model group as JAX places
it (``parallel.tensor``; any model, refused where a placement is uneven). Each rank runs on
``cuda:{rank % device_count}`` (or the CPU). Logs, the periodic eval and the
checkpoint files are rank 0's; the eval of a split model runs on a gathered
copy. The model trains in f32 on the plain versions of its kernels
(``registry.set_kernels(model, False)``), with autograd; the periodic eval
and a distillation teacher run on the kernels.

Kept from JAX: the generator of the latent noise restarts from
``manual_seed`` on resume, as JAX's key does (JAX checkpoints no key), so a
resumed run draws other noise than a straight one from the resume on.

Images reach the datasets through ``_stage_dataset`` and the eval through
``_eval_images``: both read the configuration's CSV and PNG files (PIL); a
subclass can hand over arrays instead. The loader's "auto" backend, as in
JAX, assembles the batches in the native C++ path when the dataset is
``native_compatible()``, else in a thread pool: the same batches, bitwise.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np
import torch

from irdu_tpu_torch.data.dataset import PatchDataset
from irdu_tpu_torch.data.loader import batched_loader, device_prefetch
from irdu_tpu_torch.eval.harness import evaluate_pairs, load_benchmark_images
from irdu_tpu_torch.models.registry import create_model, set_kernels, set_remat
from irdu_tpu_torch.parallel.mesh import build_mesh, init_distributed, world_size
from irdu_tpu_torch.parallel.tensor import check_tp_divisibility, full_state_dict
from irdu_tpu_torch.predict import batch_forward
from irdu_tpu_torch.train.checkpoints import CheckpointManager
from irdu_tpu_torch.train.schedules import (flagship_lr_schedule, multistep_schedule,
                                            multistep_then_cosine)
from irdu_tpu_torch.train.steps import (create_train_state, distribute,
                                        make_distill_train_step, make_train_step)
from irdu_tpu_torch.utils.config import pretty_config
from irdu_tpu_torch.utils.logging import get_root_logger
from irdu_tpu_torch.utils.seeding import set_random_seed


def build_schedule(conf: dict):
    """The schedule a configuration's ``train.schedule`` names ("flagship",
    "multistep", "multistep_then_cosine", "constant"); ``step_offset`` S
    shifts it, so that update k takes the lr of update k + S."""
    kind = conf.get("type", "flagship")
    off = int(conf.get("step_offset", 0))
    if off:
        inner = build_schedule({k: v for k, v in conf.items() if k != "step_offset"})
        return lambda step: inner(step + off)
    if kind == "flagship":
        return flagship_lr_schedule()
    if kind == "multistep":
        return multistep_schedule(conf["base_lr"], conf["milestones"], conf.get("gamma", 0.5))
    if kind == "multistep_then_cosine":
        return multistep_then_cosine(
            conf["base_lr"], conf["milestones"], conf["gamma"], conf["switch_step"],
            conf["cosine_base_lr"], conf["cosine_t_max"], conf.get("eta_min", 1e-6))
    if kind == "constant":
        return lambda step: conf["base_lr"]
    raise ValueError(f"unknown schedule type {kind}")


def resolve_parallel(par_conf: dict, world: int | None = None) -> tuple[int, int]:
    """(data_parallel, tensor_parallel) of a configuration's ``parallel``
    section on ``world`` ranks (default: the process group's size, 1
    without one), JAX's rule: "auto" is ``world // tensor_parallel`` (at
    least 1). ValueError when dp · tp is not the world size."""
    world = world_size() if world is None else world
    n_tp = int(par_conf.get("tensor_parallel", 1))
    n_dp = par_conf.get("data_parallel", "auto")
    n_dp = max(1, world // n_tp) if n_dp == "auto" else int(n_dp)
    if n_dp * n_tp != world:
        raise ValueError(f"data_parallel={n_dp} x tensor_parallel={n_tp} needs {n_dp * n_tp} "
                         f"ranks; the run has {world} (torchrun --nproc_per_node "
                         f"{n_dp * n_tp})")
    return n_dp, n_tp


class Trainer:
    def __init__(self, config: dict[str, Any], workdir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.name = config["name"]
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = init_distributed("cuda")  # cuda:{rank % device_count}
        else:
            init_distributed(device.type)
        self.device = device
        self.workdir = workdir or os.path.join(
            config.get("path", {}).get("root_dir", "experiments"), self.name)
        os.makedirs(self.workdir, exist_ok=True)
        n_dp, n_tp = resolve_parallel(config.get("parallel", {}))
        self.mesh = build_mesh(n_dp, n_tp, self.device)
        self.rank0 = self.mesh.rank == 0
        self.logger = get_root_logger(
            f"irdu.{self.name}" + ("" if self.rank0 else f".rank{self.mesh.rank}"),
            log_level=logging.INFO if self.rank0 else logging.WARNING,
            log_file=os.path.join(self.workdir, "train.log") if self.rank0 else None)
        self.logger.info("config:\n%s", pretty_config(config))
        self.logger.info("mesh: data_parallel=%d tensor_parallel=%d", n_dp, n_tp)

        # seeds the model's initial parameters too (torch's default generators)
        self.generator = set_random_seed(config.get("manual_seed", 2204), self.device)
        model_conf = dict(config["model"])
        self.model = create_model(model_conf.pop("type"), **model_conf).to(self.device)
        if n_tp > 1:  # JAX's placement must divide (ValueError before any step)
            check_tp_divisibility(self.model, n_tp)
        set_kernels(self.model, False)
        self._remat_default = bool(config["model"].get("remat", False))

        tc = config["train"]
        self.state = create_train_state(
            self.model, build_schedule(tc.get("schedule", {"type": "flagship"})))
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info("Init model with total parameters: %d", n_params)

        loss_kw = dict(use_aux_losses=tc.get("use_aux_losses", True),
                       loss02_weight=tc.get("loss02_weight", 0.1),
                       loss03_weight=tc.get("loss03_weight", 0.5))
        distill = tc.get("distill")
        self.teacher = None
        if distill:
            # train.distill: {model: {...}, weights: npz path, weight: 1.0,
            # dtype: bfloat16}: a frozen teacher on the kernels
            from irdu_tpu_torch.utils.weights import load_params_npz, params_to_torch

            t_conf = dict(distill["model"])
            self.teacher = create_model(t_conf.pop("type"), **t_conf)
            params_to_torch(load_params_npz(distill["weights"]), self.teacher)
            t_dtype = getattr(torch, distill.get("dtype", "bfloat16"))
            self.teacher = self.teacher.to(device=self.device, dtype=t_dtype).eval()
            self.teacher.requires_grad_(False)
            set_kernels(self.teacher, True)
            self.logger.info("distilling from %s (weight=%.3g)", distill["weights"],
                             distill.get("weight", 1.0))
            self.train_step = make_distill_train_step(
                self.teacher, distill_weight=distill.get("weight", 1.0), **loss_kw)
        else:
            self.train_step = make_train_step(**loss_kw)

        self.ckpt = CheckpointManager(os.path.join(self.workdir, "checkpoints"),
                                      max_to_keep=tc.get("keep_checkpoints", 5),
                                      mesh=self.mesh)
        # restored in the single-device layout, then cut to the mesh
        self.state, self.data_state = self.ckpt.restore(self.state)
        if self.data_state:
            # a restored run must not restart from scratch without a word
            assert self.state.step > 0, (
                "resume restored data_state but state.step == 0: the checkpoint "
                "restore returned a fresh train state")
            self.logger.info("Resumed from step %d", self.state.step)
        distribute(self.state, self.mesh)

        self.verbose_rate = tc.get("verbose_rate", 100)
        self.ckpt_rate = tc.get("checkpoint_rate", 5000)
        self.eval_rate = tc.get("eval_rate", 1000)

    def _train_step_for(self, remat: bool | None):
        """The train step with a stage's ``remat`` override applied by
        flipping the model's switch (``registry.set_remat``; None: the
        model's configured value). The parameters and their names do not
        change, so the state carries over; a distillation run takes the
        override too (JAX warns and ignores it there, its step being built
        around one model)."""
        set_remat(self.model, self._remat_default if remat is None else bool(remat))
        return self.train_step

    # -- data ------------------------------------------------------------

    def _stage_dataset(self, stage: dict, epoch: int, **extra) -> PatchDataset:
        """The stage's dataset for ``epoch`` (seed + epoch); ``extra`` goes to
        ``PatchDataset`` (``images=`` hands the images over as arrays)."""
        dc = dict(self.config["datasets"]["train"])
        lam = dc.get("lambda_noise", 25.0)
        if isinstance(lam, list):  # vary_addictive_noise: [levels, probs]
            lam = (lam[0], lam[1])
        extras = {k: dc[k] for k in ("sampling", "patch_overlap_size", "clip_noisy")
                  if k in dc}
        if "patch_overlap_size" in extras:
            extras["patch_overlap_size"] = tuple(extras["patch_overlap_size"])
        return PatchDataset(
            csv_path=dc["csv_path"],
            root_folder=dc["root_folder"],
            patch_size=(stage["patch_size"], stage["patch_size"]),
            max_num_patchs=stage.get("max_num_patchs", 100000),
            dist_mode=dc.get("dist_mode", "addictive_noise_scale"),
            lambda_noise=lam,
            use_data_aug=dc.get("use_data_aug", True),
            seed=dc.get("seed", 2204) + epoch,
            **extras, **extra)

    # -- eval ------------------------------------------------------------

    def _eval_images(self, spec: dict) -> list[np.ndarray]:
        """An eval set's uint8 images, from its CSV index (needs PIL)."""
        return load_benchmark_images(spec["csv_path"], spec["root_folder"])

    def _eval_model(self) -> torch.nn.Module | None:
        """The model the eval runs, on rank 0 (None elsewhere): the student
        itself, or under tp > 1 a whole copy built from the gathered
        parameters (every rank takes part in the gather)."""
        if self.mesh.tp == 1:
            return self.model if self.rank0 else None
        sd = full_state_dict(self.model, self.mesh)
        if not self.rank0:
            return None
        conf = dict(self.config["model"])
        model = create_model(conf.pop("type"), **conf).to(self.device)
        model.load_state_dict(sd)
        return model

    def run_eval(self) -> dict[str, float]:
        """The eval protocol on each configured set, on rank 0, the model on
        its kernels (the served forward, in the model's dtype) and back off
        after; {} on the other ranks."""
        results = {}
        eval_conf = self.config.get("eval")
        if not eval_conf:
            return results
        model = self._eval_model()
        if model is not None:
            set_kernels(model, True)
            try:
                for name, spec in eval_conf.get("datasets", {}).items():
                    out = evaluate_pairs(batch_forward(model), self._eval_images(spec),
                                         eval_conf.get("sigma", 25.0),
                                         bucket=eval_conf.get("bucket"))
                    results[name] = out["mean_psnr"]
                    self.logger.info("FINISH VAL step=%d dataset=%s psnr_testing=%.4f",
                                     self.state.step, name, out["mean_psnr"])
            finally:
                set_kernels(model, False)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        return results

    # -- loop ------------------------------------------------------------

    def run(self) -> dict:
        tc = self.config["train"]
        num_epochs = tc.get("num_epochs", 1)
        max_steps = tc.get("max_steps")
        psnr_hist, mse_hist = [], []
        start_epoch = (self.data_state or {}).get("epoch", 0)
        start_stage = (self.data_state or {}).get("stage", 0)
        skip = (self.data_state or {}).get("offset", 0)

        i = self.state.step
        for epoch in range(num_epochs):
            if epoch < start_epoch:
                continue
            for stage_idx, stage in enumerate(tc["stages"]):
                if epoch == start_epoch and stage_idx < start_stage:
                    continue
                ds = self._stage_dataset(stage, epoch)
                step_fn = self._train_step_for(stage.get("remat"))
                # index-only fast-forward on resume: the batches a replay would
                # give (each item a function of its index), at no loader cost
                skip_here = skip if (epoch == start_epoch and stage_idx == start_stage) else 0
                loader = device_prefetch(
                    batched_loader(ds, stage["batch_size"], skip_batches=skip_here,
                                   shard=(self.mesh.data_index, self.mesh.dp)),
                    self.device)
                offset = skip_here
                for noisy, clean in loader:
                    offset += 1
                    t0 = time.time()
                    self.state, metrics = step_fn(self.state, noisy, clean, self.generator)
                    i += 1
                    if i % self.verbose_rate == 0:
                        psnr_hist.append(float(metrics["psnr"]))
                        mse_hist.append(float(metrics["mse"]))
                        self.logger.info(
                            "iter=%d time=%.3f psnr=%.4f mse=%.6f",
                            i, time.time() - t0,
                            float(np.mean(psnr_hist[-100:])),
                            float(np.mean(mse_hist[-100:])))
                    if self.ckpt_rate and i % self.ckpt_rate == 0:
                        self.ckpt.save(i, self.state,
                                       {"epoch": epoch, "stage": stage_idx, "offset": offset})
                    if self.eval_rate and i % self.eval_rate == 0:
                        self.run_eval()
                    if max_steps and i >= max_steps:
                        self.ckpt.save(i, self.state,
                                       {"epoch": epoch, "stage": stage_idx, "offset": offset})
                        self.ckpt.wait()
                        return {"step": i}
        # epoch == num_epochs marks the run complete: a resume skips every
        # epoch and falls straight through instead of replaying the last stage
        self.ckpt.save(i, self.state, {"epoch": num_epochs, "stage": 0, "offset": 0})
        self.ckpt.wait()
        return {"step": i}
