"""Model registry: a configuration's ``model.type`` → the port's module
(counterpart: ``irdu_tpu/models/registry.py``), under JAX's names: the
flagship, the pixel family, the ablations, GLR boosting and the baselines.
``create_model(name, **kwargs)`` builds one, randomly initialized, from a
configuration's ``model`` section without its ``type``;
``utils.weights.params_to_torch`` puts JAX parameters on it. The models
accept every field of JAX's; a value the port does not compute raises
``NotImplementedError`` naming the field (``require``), and says whether JAX
refuses it too or the port has not ported it yet."""

from __future__ import annotations

from typing import Callable

from torch import nn


def _registry() -> dict[str, Callable[..., nn.Module]]:
    from irdu_tpu_torch.baselines.drunet import (
        IRCNN,
        DnCNN,
        FDnCNN,
        NonLocalUNet,
        ResUNet,
        UNet,
        UNetPlus,
        UNetRes,
        UNetResSubP,
    )
    from irdu_tpu_torch.baselines.restormer import Restormer
    from irdu_tpu_torch.baselines.swinir import SwinIR
    from irdu_tpu_torch.models.ablations import MultiScaleGraphFilter, OneGraphFilter
    from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
    from irdu_tpu_torch.models.glr_boosting import GLRBoostingPyramid
    from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser

    return {"abstract_multiscale_graph_filter": AbstractMultiScaleGraphFilter,
            "multiscale_sequence_denoiser": MultiScaleSequenceDenoiser,
            "multiscale_graph_filter": MultiScaleGraphFilter,
            "one_graph_filter": OneGraphFilter,
            "glr_boosting_pyramid": GLRBoostingPyramid,
            "restormer": Restormer, "swinir": SwinIR,
            "dncnn": DnCNN, "fdncnn": FDnCNN, "ircnn": IRCNN, "drunet": UNetRes,
            "unet": UNet, "resunet": ResUNet, "unetres_subp": UNetResSubP,
            "unetplus": UNetPlus, "nonlocal_unet": NonLocalUNet}


def require(field: str, value, supported, jax_refuses: str | None = None) -> None:
    """NotImplementedError naming ``field`` unless ``value`` is one of
    ``supported``. Without ``jax_refuses``, JAX builds the other values and
    the port does not yet; with it, JAX refuses them too, for that reason."""
    if value in supported:
        return
    if jax_refuses is None:
        raise NotImplementedError(
            f"{field}={value!r} is not ported yet; the port builds {field} in {supported}")
    raise NotImplementedError(
        f"{field}={value!r}: JAX refuses it too ({jax_refuses}); {field} takes {supported}")


def available_models() -> list[str]:
    return sorted(_registry())


def create_model(name: str, **kwargs) -> nn.Module:
    """The model ``name`` built with ``kwargs``; KeyError, with the available
    names, for a name neither registry has."""
    registry = _registry()
    if name not in registry:
        raise KeyError(f"unknown model {name!r}; available: {sorted(registry)}")
    return registry[name](**kwargs)


def set_kernels(model: nn.Module, on: bool) -> None:
    """Route every module of ``model`` that has the switch (the flagship's
    blocks and solvers, the ablations' feature heads and solvers, the pixel
    solver, GLR boosting's levels) through the kernels (True) or their plain versions (False, on any
    device: the differentiable route training takes)."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = on


def set_remat(model: nn.Module, on: bool) -> None:
    """Flip ``remat`` on every module of ``model`` that has it (the
    flagship; the pixel solver and its feature U-Net; Restormer, SwinIR's
    groups): recompute the blocks
    in the backward pass instead of keeping their activations."""
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = on
