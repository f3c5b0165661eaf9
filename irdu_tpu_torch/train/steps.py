"""Training steps (counterpart: ``irdu_tpu/train/steps.py``).

The flagship objective:

  L = L1(model(noisy), clean)
    + 0.1 · MSE(dec(enc(clean)), clean)                (autoencoder consistency)
    + 0.5 · MSE(dec(enc(clean)), dec(enc(clean)+ξ)),   ξ ~ N(0, 0.05) per scale
                                                       (latent robustness)

with no stop-gradient between the two decodes, minimised by Adam (optax's
formula: eps 1e-8 outside the square root, bias-corrected moments) at the
schedule's lr of each update.

The model trains on the plain versions of its kernels with autograd, as JAX
trains on its jnp path (its Pallas kernels have no VJP): ``train.trainer``
switches the student's kernels off (``registry.set_kernels``), and a kernel
wrapper handed a tensor that requires grad raises. A distillation teacher is
frozen and runs its forward on the kernels under ``torch.inference_mode``.

On a dp × tp mesh (``distribute``) each rank takes its slice of the global
batch, and the objective is wrapped in ``DistributedDataParallel`` over the
data group, which averages the gradients: the slices are equal, so the
ranks' mean losses average to the global batch's. The latent noise is drawn
at the global batch's shape from the generator every rank seeds alike, and
each rank keeps its rows, so that a step is one device's step on the same
global batch. The logged loss and MSE are averaged over the data group and
the PSNR taken from that MSE. Under tp > 1 the model is split
(``parallel.tensor``): the objective runs on the whole tensors of the
parameters it gathers where they are used (``gathered_params``, through
``torch.func.functional_call``), and the gradients are completed over the
model group before the update. A distillation teacher runs whole on each rank's slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from irdu_tpu_torch.parallel.mesh import Mesh
from irdu_tpu_torch.parallel.tensor import (gathered_params, reduce_model_grads,
                                            shard_train_state)


@dataclass
class TrainState:
    """The model, its Adam optimizer, the lr schedule and the number of
    updates applied so far (the step); on a mesh (``distribute``) the mesh
    and, with more than one data rank, the DDP-wrapped objective (``ddp``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    mesh: Mesh | None = None
    ddp: nn.Module | None = None


def create_train_state(model: nn.Module, schedule: Callable[[int], float], *,
                       eps: float = 1e-8) -> TrainState:
    """Adam (betas 0.9, 0.999, optax's defaults) over the model's parameters
    in their order."""
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0), eps=eps)
    return TrainState(model, optimizer, schedule)


class _Loss(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, noisy, clean, **kw):
        return flagship_loss(self.model, noisy, clean, **kw)


class Objective(_Loss):
    """``flagship_loss`` of ``model`` as a module's forward: the unit DDP
    wraps (its gradient hooks see the whole loss's graph at once). On a
    sharded model the loss takes the gathered parameters in place of their
    slices for the call."""

    def forward(self, noisy, clean, **kw):
        full = gathered_params(self.model)
        if not full:
            return super().forward(noisy, clean, **kw)
        return torch.func.functional_call(_Loss(self.model),
                                          {f"model.{n}": t for n, t in full.items()},
                                          (noisy, clean), kw, strict=False)


def distribute(state: TrainState, mesh: Mesh) -> TrainState:
    """Put a single-device-layout train state on ``mesh``, in place: cut to
    this rank's slices under tp > 1 (``parallel.tensor.shard_train_state``)
    and, with more than one data rank, the objective wrapped in
    ``DistributedDataParallel`` over the data group (which broadcasts the
    group's first rank's parameters as it is built) and each BatchNorm
    normalizing by the global batch's statistics."""
    from torch.nn.parallel import DistributedDataParallel

    from irdu_tpu_torch.baselines.blocks import BatchNorm

    shard_train_state(state, mesh)
    state.mesh = mesh
    if mesh.dp > 1:
        for mod in state.model.modules():
            if isinstance(mod, BatchNorm):
                mod.data = (mesh.data_group, mesh.dp)
        dev = next(state.model.parameters()).device
        state.ddp = DistributedDataParallel(
            Objective(state.model), device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=mesh.data_group, broadcast_buffers=False)
    return state


def apply_gradients(state: TrainState) -> None:
    """One Adam update from the parameters' ``.grad`` at lr
    ``schedule(step)``: update k, counted from 0, takes ``schedule(k)`` as
    optax's ``scale_by_learning_rate`` does."""
    lr = float(state.schedule(state.step))
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def draw_latent_noise(codes: Sequence[torch.Tensor], generator: torch.Generator | None,
                      shard: tuple[int, int] | None = None) -> tuple[torch.Tensor, ...]:
    """One standard normal draw per code, of its shape, from ``generator``
    (which must sit on the codes' device). ``shard`` (index, count): the
    codes are slice ``index`` of ``count`` equal slices of a global batch;
    each draw is made at the global batch's shape and this slice kept."""
    index, count = shard or (0, 1)
    out = []
    for c in codes:
        b = c.shape[0]
        full = torch.randn((b * count,) + tuple(c.shape[1:]), generator=generator,
                           device=c.device, dtype=c.dtype)
        out.append(full[index * b:(index + 1) * b] if count > 1 else full)
    return tuple(out)


def flagship_loss(model: nn.Module, noisy: torch.Tensor, clean: torch.Tensor, *,
                  latent_noise: Sequence[torch.Tensor] | None = None,
                  generator: torch.Generator | None = None, loss02_weight: float = 0.1,
                  loss03_weight: float = 0.5, latent_noise_std: float = 0.05,
                  use_aux_losses: bool = True, latent_shard: tuple[int, int] | None = None):
    """(loss, denoised) on NHWC batches. latent_noise: the standard normal
    draws, one per code (B, C_s, H_s, W_s), scaled here by
    ``latent_noise_std``; None draws them from ``generator`` (``latent_shard``:
    the batch's slice of a global batch, as ``draw_latent_noise`` takes it)."""
    denoised = model(noisy)
    loss = torch.mean(torch.abs(denoised - clean))
    if use_aux_losses:
        latent = model.encode(clean)
        recon = model.decode(latent)
        if latent_noise is None:
            latent_noise = draw_latent_noise(latent, generator, latent_shard)
        disturbed = tuple(c + latent_noise_std * n for c, n in zip(latent, latent_noise))
        recon_disturbed = model.decode(disturbed)
        loss = loss + loss02_weight * torch.mean(torch.square(recon - clean))
        loss = loss + loss03_weight * torch.mean(torch.square(recon - recon_disturbed))
    return loss, denoised


def batch_metrics(loss: torch.Tensor, denoised: torch.Tensor, clean: torch.Tensor,
                  group=None, ranks: int = 1) -> dict[str, torch.Tensor]:
    """The train log's metrics, detached, on the batch's device: the loss and
    the clipped-PSNR of the batch (MSE of both clipped to [0, 1]). With a
    data ``group`` of ``ranks`` equal slices, the loss and the MSE are first
    averaged over it: the global batch's."""
    with torch.no_grad():
        mse = torch.mean(torch.square(clean.clamp(0.0, 1.0) - denoised.clamp(0.0, 1.0)))
        loss = loss.detach()
        if ranks > 1:
            both = torch.stack([loss.float(), mse.float()])
            dist.all_reduce(both, group=group)
            loss, mse = (both / ranks).unbind()
        psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
    return {"loss": loss, "mse": mse, "psnr": psnr}


def make_train_step(*, use_aux_losses: bool = True, loss02_weight: float = 0.1,
                    loss03_weight: float = 0.5, latent_noise_std: float = 0.05,
                    extra_loss: Callable | None = None) -> Callable:
    """``step(state, noisy, clean, generator=None, latent_noise=None)`` →
    (state, metrics): the loss, its backward pass and one Adam update, in
    place on the state's model and optimizer. extra_loss(noisy, denoised):
    a term added to the loss (the distillation term). On a mesh, ``noisy``
    and ``clean`` are this rank's slices, and so is ``latent_noise`` when
    given."""

    def step(state: TrainState, noisy, clean, generator=None, latent_noise=None):
        mesh = state.mesh
        dp = mesh.dp if mesh is not None else 1
        state.optimizer.zero_grad(set_to_none=True)
        loss, denoised = (state.ddp or Objective(state.model))(
            noisy, clean, latent_noise=latent_noise, generator=generator,
            loss02_weight=loss02_weight, loss03_weight=loss03_weight,
            latent_noise_std=latent_noise_std, use_aux_losses=use_aux_losses,
            latent_shard=(mesh.data_index, dp) if dp > 1 else None)
        if extra_loss is not None:
            loss = loss + extra_loss(noisy, denoised)
        loss.backward()
        reduce_model_grads(state.model, mesh)
        apply_gradients(state)
        return state, batch_metrics(loss, denoised, clean,
                                    mesh.data_group if dp > 1 else None, dp)

    return step


def teacher_forward(teacher: nn.Module, noisy: torch.Tensor) -> torch.Tensor:
    """The frozen teacher's output for ``noisy``: the input cast to the
    teacher's dtype, the forward under ``torch.inference_mode`` (on the card,
    through its kernels), the output cast back to ``noisy``'s dtype and
    copied out of inference mode, so that autograd can take it as a
    constant."""
    t_dtype = next(teacher.parameters()).dtype
    with torch.inference_mode():
        out = teacher(noisy.to(t_dtype)).to(noisy.dtype)
    return out.clone()


def make_distill_train_step(teacher: nn.Module, *, distill_weight: float = 1.0,
                            **loss_kw) -> Callable:
    """The train step with knowledge distillation: the flagship loss plus
    ``distill_weight`` · L1(student(noisy), teacher(noisy)), the teacher a
    constant (``teacher_forward``). ``loss_kw``: ``make_train_step``'s."""

    def distill_term(noisy, denoised):
        return distill_weight * torch.mean(torch.abs(denoised - teacher_forward(teacher, noisy)))

    return make_train_step(extra_loss=distill_term, **loss_kw)
