"""Tensor and expert parallelism for every model, under JAX's placement
rules (counterpart: ``irdu_tpu/parallel/tensor.py``).

JAX places a train state on a dp × tp mesh by ``spec_for_param``: by name,
the gated blocks' 1×1 expand kernel by column, their depthwise kernel by
channel and every ``project_out`` 1×1 kernel by row; the solvers'
per-graph parameters (``alphaCGD``/``betaCGD`` (iters, G), ``ro*``,
``gamma*``, ``muys*`` (G,), ``multiM``/``stats_*`` (G, F)) by graph. Every
other parameter is whole on every device. ``jax.device_put`` refuses a
placement whose size along the model axis tp does not divide; so does the
port (``check_tp_divisibility``, before any step: the parameter, its size,
tp). The port places the same parameters along the same axes, and runs
them in one of two ways.

Split modules, whose compute is divided over the model axis:

  * a ``LocalGatedLinearBlock`` of one subnet (1×1 expand → 3×3 depthwise →
    gate σ(m)·m·u → 1×1 project; the flagship family's, the ablation
    heads', GLR boosting's), the Megatron way: a rank holds its slice of
    both halves of the 2·hidden expand (mask channels r·h/tp … (r+1)·h/tp
    and the same u channels), the same depthwise channels, so that its gate
    is local, and the matching input rows of the project; one all-reduce of
    the block's output. (JAX's column split of the expand leaves all mask
    channels on one device at tp = 2 and lets GSPMD reshard; the port does
    not copy that layout, and asks that tp divide the hidden width.)
  * a ``MixtureGTVGLR`` over its graph hypotheses, as experts: the feature
    heads stay whole on every rank, a rank solves its G/tp graphs (its
    F-channel slices of the code and the matching GTV and GLR feature rows)
    with its slices of the per-graph parameters, and the solved channels
    are gathered.

Gathered where they are used: every other parameter JAX places (a
``project_out`` outside a gated block, the per-graph tables of the pixel
family's ``MixtureGTV``, of the ablation solvers and of boosting's solver,
and the grouped expand and project of a block of ``nsubnets`` > 1, which
JAX splits by the column of its (C, 2H/g) kernel). A rank holds JAX's slice
of it, in JAX's layout (a kernel as its flax kernel: ``Placement.view``),
with its Adam moments sliced the same way, and the train step's objective
runs on the whole tensors gathered from the slices (``gathered_params``,
``gather_full``, whose backward is the adjoint). So memory is placed as
JAX places it and the compute is the single-device function; an expert
split of ``MixtureGTV``'s solve would be a speed change, not made here.

A rank's parameters and Adam moments are cut to its slice in place
(``shard_train_state``); ``full_state_dict`` and ``gather_train_state`` put
them back together in the single-device layout (checkpoints, snapshots,
the eval), which JAX's ``load_params_npz`` reads.

Gradients. The collectives are all-reduces through
``torch.distributed.nn.functional`` (a gather too: ``gather_full``), whose
backward is the forward's adjoint, an all-reduce of the gradient. Each
rank's backward then gives the gradient of the SUM of the tp ranks' (equal)
losses with respect to its own tensors: tp times the true gradient on a
slice, and, on a whole parameter, the part that flows through this rank's
tensors. ``reduce_model_grads`` sums the whole parameters' gradients over
the model group and divides every gradient by tp, after which each rank
holds the single-device gradient of what it holds.

JAX names: ``spec_for_param`` gives a ``Placement`` (the split dim of the
torch tensor, or of its ``view``) or None (whole) where JAX gives a
``PartitionSpec``; ``param_shardings`` and ``train_state_shardings`` are
dicts by parameter name where JAX's are trees of ``NamedSharding``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from irdu_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, build_mesh, world_size

__all__ = ["DATA_AXIS", "MODEL_AXIS", "ModelShard", "Placement", "check_tp_divisibility",
           "full_state_dict", "gather_full", "gather_train_state", "gathered_params",
           "local_part", "make_dp_tp_mesh", "model_shard", "param_shardings",
           "reduce_model_grads", "shard_train_state", "spec_for_param", "split_owner",
           "train_state_shardings"]

# parameters created per graph hypothesis by the solvers (solvers/gtv_glr.py,
# solvers/common.GraphOpParams; the pixel family's names, solvers/pixel_gtv.py)
_PER_GRAPH_1D = frozenset({"ro00", "ro01", "gamma00", "gamma01", "muys00", "muys01",
                           "ro", "gamma", "muy"})
_PER_GRAPH_ITER = frozenset({"alphaCGD", "betaCGD"})


@dataclass(frozen=True)
class Placement:
    """A tensor split over the model axis along ``dim``; ``paired``: the dim
    is two halves (the gated expand's mask and u), each split alike;
    ``view``: the owning module, whose ``kernel_from_torch`` gives the
    layout ``dim`` indexes (JAX's kernel; a rank holds its slice in that
    layout) and ``kernel_to_torch`` takes it back; None: the tensor's own."""

    dim: int
    paired: bool = False
    view: object = None

    def indices(self, size: int, index: int, tp: int) -> torch.Tensor:
        """The positions along ``dim`` (of ``size``) that model rank ``index``
        of ``tp`` holds, in the order it holds them."""
        if self.paired:
            half, n = size // 2, size // 2 // tp
            lo = torch.arange(index * n, (index + 1) * n)
            return torch.cat([lo, lo + half])
        n = size // tp
        return torch.arange(index * n, (index + 1) * n)

    def to_view(self, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor in the layout ``dim`` indexes."""
        return t if self.view is None else self.view.kernel_from_torch(t)

    def from_view(self, t: torch.Tensor) -> torch.Tensor:
        """The inverse of ``to_view``."""
        return t if self.view is None else self.view.kernel_to_torch(t)


@dataclass(frozen=True, eq=False)
class ModelShard:
    """A module's place on the model axis: its group, index and size."""

    group: object
    index: int
    size: int


def make_dp_tp_mesh(tp: int = 1, device=None) -> Mesh:
    """The ("data", "model") mesh over every rank: ranks d·tp … d·tp + tp − 1
    share data index d (JAX's ``reshape(n // tp, tp)``)."""
    n = world_size()
    if n < tp or n % tp != 0:
        raise ValueError(
            f"tensor_parallel={tp} needs a device count divisible by {tp}; got {n}. "
            f"Launch that many ranks (torchrun --nproc_per_node N).")
    return build_mesh(n // tp, tp, device)


def check_tp_divisibility(model, tp: int) -> None:
    """ValueError, before any step, where the model axis of size ``tp``
    cannot hold the model as JAX places it: a parameter ``spec_for_param``
    places whose size along that axis tp does not divide (the message names
    it, its size and tp, as ``jax.device_put`` refuses it; a paired dim asks
    it of each half); and, for a model with ``hidden_dims`` (the flagship
    family), JAX's rule that tp divide each 2·hidden and each scale's graph
    count, the port's paired layout asking it of each hidden width of a
    scale of one subnet."""
    hidden = getattr(model, "hidden_dims", None)
    if hidden is not None:
        subnets = getattr(model, "nsubnets", (1,) * len(hidden))
        for hd, ns in zip(hidden, subnets):
            if (2 * hd) % tp or (ns == 1 and hd % tp):
                raise ValueError(f"hidden_dim {hd} (each half of 2*hidden {2 * hd}) % tp {tp} != 0")
        for g in model.ngraphs:
            if g % tp:
                raise ValueError(f"ngraphs {g} % tp {tp} != 0")
    params = dict(model.named_parameters())
    for name, pl in param_shardings(model).items():
        if pl is None:
            continue
        shape = tuple(pl.to_view(params[name].detach()).shape)
        size = shape[pl.dim] // 2 if pl.paired else shape[pl.dim]
        if size % tp:
            raise ValueError(
                f"{name}: size {size}{' (each half)' if pl.paired else ''} along the model "
                f"axis % tp {tp} != 0 (JAX's layout {shape}, axis {pl.dim}): JAX's device_put "
                "refuses this uneven placement")


# JAX's axis of a kernel it places, by the kernel's parent module name and
# its flax rank (``irdu_tpu/parallel/tensor.py``)
_KERNEL_AXES = {("channels_linear_op", 2): 1, ("channels_local_linear_op", 4): 3,
                ("project_out", 2): 0}
# the split gated block's placement of each of those, in the torch layout
_SPLIT_BLOCK = {1: Placement(0, paired=True), 3: Placement(0, paired=True), 0: Placement(1)}


def spec_for_param(name: str, leaf: torch.Tensor, owner: nn.Module | None = None,
                   split: bool = True) -> Placement | None:
    """The placement of one parameter by its dotted name (the port's names
    mirror flax's; a conv's ``weight`` is flax's ``kernel``) and its whole
    shape; ``owner`` the module that holds it (its ``kernel_from_torch``
    gives the kernel's flax rank; None: read from the shape). JAX's rules:
    a gated expand by output channel, its depthwise by channel, a
    ``project_out`` by input channel; ``alphaCGD``/``betaCGD`` (iters, G) by
    graph; ``ro*``/``gamma*``/``muys*`` (G,) and ``multiM``/``stats_*``
    (G, F) by graph. Anything else (None) is whole on every rank. ``split``:
    the kernel belongs to a split gated block (the paired torch-layout
    placement), else it is held as JAX's slice of its kernel (``view``). The
    same rules place Adam's moments, which have their parameter's shape."""
    names = name.split(".")
    last, parent = names[-1], names[-2] if len(names) > 1 else ""
    ndim = leaf.ndim
    if last == "weight":
        if owner is not None and hasattr(owner, "kernel_from_torch"):
            flax_ndim = owner.kernel_from_torch(leaf.detach()).ndim
        else:
            flax_ndim = 2 if ndim == 4 and tuple(leaf.shape[2:]) == (1, 1) else ndim
        axis = _KERNEL_AXES.get((parent, flax_ndim))
        if axis is None:
            return None
        return _SPLIT_BLOCK[axis] if split else Placement(axis, view=owner)
    if last in _PER_GRAPH_ITER and ndim == 2:
        return Placement(1)  # (n_iters, G)
    if last in _PER_GRAPH_1D and ndim == 1:
        return Placement(0)  # (G,)
    if (last == "multiM" or last.startswith("stats_")) and ndim == 2:
        return Placement(0)  # (G, F)
    return None


def param_shardings(model: nn.Module) -> dict[str, Placement | None]:
    """``spec_for_param`` of every parameter, by name: what a split module
    owns (``split_owner``) in its split layout, the rest in JAX's. Once the
    model is sharded, the placements it was cut by."""
    held = model.__dict__.get("_tp_placements")
    if held is not None:
        return held
    out = {}
    for name, p in model.named_parameters():
        owner = name.rpartition(".")[0]
        out[name] = spec_for_param(name, p, model.get_submodule(owner) if owner else model,
                                   split_owner(model, name) is not None)
    return out


def train_state_shardings(state) -> dict[str, dict[str, Placement | None]]:
    """The placement of every tensor of a ``steps.TrainState``: per
    parameter name, the parameter's and its Adam moments' (``exp_avg``,
    ``exp_avg_sq``); Adam's step count is whole."""
    return {n: {"param": pl, "exp_avg": pl, "exp_avg_sq": pl, "step": None}
            for n, pl in param_shardings(state.model).items()}


def _split_modules():
    from irdu_tpu_torch.models.blocks import LocalGatedLinearBlock
    from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR

    return LocalGatedLinearBlock, MixtureGTVGLR


def split_owner(model: nn.Module, name: str) -> nn.Module | None:
    """The split module that owns parameter ``name`` (the innermost
    ``LocalGatedLinearBlock`` of one subnet or ``MixtureGTVGLR`` on its
    path), or None: the parameter is gathered where it is used."""
    kinds = _split_modules()
    parts = name.split(".")
    for k in range(len(parts) - 1, 0, -1):
        mod = model.get_submodule(".".join(parts[:k]))
        if isinstance(mod, kinds):
            return mod if getattr(mod, "nsubnets", 1) == 1 else None
    return None


def shard_train_state(state, mesh: Mesh) -> None:
    """Cut a (single-device layout) train state to this rank's slices in
    place: every parameter ``param_shardings`` places, its Adam moments
    where the optimizer has them; the split modules told their place
    (``ModelShard``), the gathered parameters recorded for
    ``gathered_params``. ValueError first where tp cannot hold the model
    (``check_tp_divisibility``). Nothing at tp = 1."""
    if mesh.tp == 1:
        return
    model = state.model
    check_tp_divisibility(model, mesh.tp)
    shard = model_shard(mesh)
    placements = param_shardings(model)
    placed = {n: pl for n, pl in placements.items() if pl is not None}
    owners = {n: split_owner(model, n) for n in placed}
    for mod in set(m for m in owners.values() if m is not None):
        mod.tp = shard
    params = dict(model.named_parameters())
    for name, pl in placed.items():
        p = params[name]
        with torch.no_grad():
            p.data = local_part(p.data, pl, shard).contiguous()
        st = state.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in st:
                st[key] = local_part(st[key], pl, shard).contiguous()
        owner = model.get_submodule(name.rpartition(".")[0])
        if owners[name] is not None and hasattr(owner, "folded"):
            # a split conv: its variant's factor reads the whole kernel
            owner.shard = (pl, shard)
            if owner.groups > 1:  # the depthwise conv: one group a channel
                owner.groups = p.shape[0]
    model.__dict__["_tp_placements"] = placements
    model.__dict__["_tp_gathered"] = (shard, [n for n in placed if owners[n] is None])


def gathered_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole tensors of the parameters a sharded ``model`` gathers where
    they are used, by name, each gathered from the model group's slices
    with its gradient (every rank calls it); {} when there are none. The
    train step runs the model on them (``torch.func.functional_call``)."""
    held = model.__dict__.get("_tp_gathered")
    if not held or not held[1]:
        return {}
    shard, names = held
    placements, params = model.__dict__["_tp_placements"], dict(model.named_parameters())
    return {n: gather_full(params[n], placements[n], shard) for n in names}


def model_shard(mesh: Mesh) -> ModelShard:
    """This rank's place on the mesh's model axis."""
    return ModelShard(mesh.model_group, mesh.model_index, mesh.tp)


def gather_full(t: torch.Tensor, pl: Placement, shard: ModelShard) -> torch.Tensor:
    """The whole tensor from every model rank's slice ``t``, on every rank
    (each calls it), with a gradient: each rank writes its slice into zeros
    and the model group all-reduces them (any backend takes an all-reduce;
    its backward is an all-reduce, the adjoint); in the tensor's own layout
    (``Placement.from_view``)."""
    shape = list(t.shape)
    shape[pl.dim] *= shard.size
    idx = pl.indices(shape[pl.dim], shard.index, shard.size).to(t.device)
    full = t.new_zeros(shape).index_copy(pl.dim, idx, t)
    return pl.from_view(dist_fn.all_reduce(full, group=shard.group))


def local_part(full: torch.Tensor, pl: Placement, shard: ModelShard) -> torch.Tensor:
    """This rank's slice of a whole tensor (in ``pl``'s view)."""
    full = pl.to_view(full)
    idx = pl.indices(full.shape[pl.dim], shard.index, shard.size).to(full.device)
    return full.index_select(pl.dim, idx)


def full_state_dict(model: nn.Module, mesh: Mesh | None = None) -> dict:
    """``model.state_dict()`` in the single-device layout (every rank of the
    model group calls it): the sliced parameters gathered."""
    sd = model.state_dict()
    if mesh is None or mesh.tp == 1:
        return sd
    with torch.no_grad():
        for name, pl in param_shardings(model).items():
            if pl is not None:
                sd[name] = gather_full(sd[name], pl, model_shard(mesh))
    return sd


def gather_train_state(state, mesh: Mesh | None = None) -> tuple[dict, dict]:
    """(model state_dict, optimizer state_dict) of a train state in the
    single-device layout: what a one-process run of the same step holds.
    Every rank of the model group calls it."""
    opt = state.optimizer.state_dict()
    if mesh is None or mesh.tp == 1:
        return state.model.state_dict(), opt
    specs = list(param_shardings(state.model).values())
    moments = {}
    with torch.no_grad():
        for i, st in opt["state"].items():
            pl = specs[i]
            moments[i] = {k: (gather_full(v, pl, model_shard(mesh))
                              if pl is not None and k != "step" else v) for k, v in st.items()}
    return full_state_dict(state.model, mesh), {"state": moments,
                                                "param_groups": opt["param_groups"]}


@torch.no_grad()
def reduce_model_grads(model: nn.Module, mesh: Mesh | None) -> None:
    """After a backward pass under tp > 1: each whole parameter's gradient
    summed over the model group (one all-reduce of them all), then every
    gradient divided by tp (the module docstring says why)."""
    if mesh is None or mesh.tp == 1:
        return
    placements = param_shardings(model)
    whole = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and placements[n] is None]
    if whole:
        flat = torch.cat([g.reshape(-1) for g in whole])
        dist.all_reduce(flat, group=mesh.model_group)
        offset = 0
        for g in whole:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(mesh.tp)

