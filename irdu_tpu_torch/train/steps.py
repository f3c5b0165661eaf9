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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn


@dataclass
class TrainState:
    """The model, its Adam optimizer, the lr schedule and the number of
    updates applied so far (the step)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: nn.Module, schedule: Callable[[int], float], *,
                       eps: float = 1e-8) -> TrainState:
    """Adam (betas 0.9, 0.999, optax's defaults) over the model's parameters
    in their order."""
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0), eps=eps)
    return TrainState(model, optimizer, schedule)


def apply_gradients(state: TrainState) -> None:
    """One Adam update from the parameters' ``.grad`` at lr
    ``schedule(step)``: update k, counted from 0, takes ``schedule(k)`` as
    optax's ``scale_by_learning_rate`` does."""
    lr = float(state.schedule(state.step))
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def draw_latent_noise(codes: Sequence[torch.Tensor],
                      generator: torch.Generator | None) -> tuple[torch.Tensor, ...]:
    """One standard normal draw per code, of its shape, from ``generator``
    (which must sit on the codes' device)."""
    return tuple(torch.randn(c.shape, generator=generator, device=c.device, dtype=c.dtype)
                 for c in codes)


def flagship_loss(model: nn.Module, noisy: torch.Tensor, clean: torch.Tensor, *,
                  latent_noise: Sequence[torch.Tensor] | None = None,
                  generator: torch.Generator | None = None, loss02_weight: float = 0.1,
                  loss03_weight: float = 0.5, latent_noise_std: float = 0.05,
                  use_aux_losses: bool = True):
    """(loss, denoised) on NHWC batches. latent_noise: the standard normal
    draws, one per code (B, C_s, H_s, W_s), scaled here by
    ``latent_noise_std``; None draws them from ``generator``."""
    denoised = model(noisy)
    loss = torch.mean(torch.abs(denoised - clean))
    if use_aux_losses:
        latent = model.encode(clean)
        recon = model.decode(latent)
        if latent_noise is None:
            latent_noise = draw_latent_noise(latent, generator)
        disturbed = tuple(c + latent_noise_std * n for c, n in zip(latent, latent_noise))
        recon_disturbed = model.decode(disturbed)
        loss = loss + loss02_weight * torch.mean(torch.square(recon - clean))
        loss = loss + loss03_weight * torch.mean(torch.square(recon - recon_disturbed))
    return loss, denoised


def batch_metrics(loss: torch.Tensor, denoised: torch.Tensor,
                  clean: torch.Tensor) -> dict[str, torch.Tensor]:
    """The train log's metrics, detached, on the batch's device: the loss and
    the clipped-PSNR of the batch (MSE of both clipped to [0, 1])."""
    with torch.no_grad():
        mse = torch.mean(torch.square(clean.clamp(0.0, 1.0) - denoised.clamp(0.0, 1.0)))
        psnr = 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))
    return {"loss": loss.detach(), "mse": mse, "psnr": psnr}


def make_train_step(*, use_aux_losses: bool = True, loss02_weight: float = 0.1,
                    loss03_weight: float = 0.5, latent_noise_std: float = 0.05,
                    extra_loss: Callable | None = None) -> Callable:
    """``step(state, noisy, clean, generator=None, latent_noise=None)`` →
    (state, metrics): the loss, its backward pass and one Adam update, in
    place on the state's model and optimizer. extra_loss(noisy, denoised):
    a term added to the loss (the distillation term)."""

    def step(state: TrainState, noisy, clean, generator=None, latent_noise=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, denoised = flagship_loss(
            state.model, noisy, clean, latent_noise=latent_noise, generator=generator,
            loss02_weight=loss02_weight, loss03_weight=loss03_weight,
            latent_noise_std=latent_noise_std, use_aux_losses=use_aux_losses)
        if extra_loss is not None:
            loss = loss + extra_loss(noisy, denoised)
        loss.backward()
        apply_gradients(state)
        return state, batch_metrics(loss, denoised, clean)

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
