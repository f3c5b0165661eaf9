"""Tensor and expert parallelism for the flagship family (counterpart:
``irdu_tpu/parallel/tensor.py``).

The "model" axis of a dp × tp mesh (``make_dp_tp_mesh``) splits:

  * each ``LocalGatedLinearBlock`` (1×1 expand → 3×3 depthwise → gate
    σ(m)·m·u → 1×1 project) the Megatron way: a rank holds its slice of
    both halves of the 2·hidden expand (mask channels r·h/tp … (r+1)·h/tp
    and the same u channels), the same depthwise channels, so that its
    gate is local, and the matching input rows of the project; one
    all-reduce of the block's output (JAX's column split of the expand
    leaves all mask channels on one device at tp = 2 and lets GSPMD
    reshard; the port does not copy that layout);
  * each ``MixtureGTVGLR`` over its graph hypotheses, as experts: the
    feature heads stay whole on every rank, a rank solves its G/tp graphs
    (its F-channel slices of the code and the matching GTV and GLR
    feature rows) with its slices of the per-graph parameters, and the
    solved channels are gathered.

Every other parameter is whole on every rank. A rank's parameters and Adam
moments are cut to its slice in place (``shard_train_state``);
``full_state_dict`` and ``gather_train_state`` put them back together in
the single-device layout (checkpoints, snapshots, the eval).

Gradients. The collectives of the forward are all-reduces through
``torch.distributed.nn.functional`` (a gather too: ``gather_full``), whose
backward is the forward's adjoint, an all-reduce of the gradient. Each
rank's backward then gives the gradient of the SUM
of the tp ranks' (equal) losses with respect to its own tensors: tp times
the true gradient on a slice, and, on a whole parameter, the part that
flows through this rank's slices. ``reduce_model_grads`` sums the whole
parameters' gradients over the model group and divides every gradient by
tp, after which each rank holds the single-device gradient of what it
holds.

JAX names: ``spec_for_param`` gives a ``Placement`` (the split dim of the
torch tensor) or None (whole) where JAX gives a ``PartitionSpec``;
``param_shardings`` and ``train_state_shardings`` are dicts by parameter
name where JAX's are trees of ``NamedSharding``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from irdu_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, build_mesh, world_size

__all__ = ["DATA_AXIS", "MODEL_AXIS", "ModelShard", "Placement", "check_tp_divisibility",
           "full_state_dict", "gather_full", "gather_train_state", "local_part",
           "make_dp_tp_mesh", "model_shard", "param_shardings", "reduce_model_grads",
           "shard_train_state", "spec_for_param", "train_state_shardings"]

# parameters created per graph hypothesis by the solvers (solvers/gtv_glr.py,
# solvers/common.GraphOpParams; the pixel family's names, solvers/pixel_gtv.py)
_PER_GRAPH_1D = frozenset({"ro00", "ro01", "gamma00", "gamma01", "muys00", "muys01",
                           "ro", "gamma", "muy"})
_PER_GRAPH_ITER = frozenset({"alphaCGD", "betaCGD"})


@dataclass(frozen=True)
class Placement:
    """A tensor split over the model axis along ``dim``; ``paired``: the dim
    is two halves (the gated expand's mask and u), each split alike."""

    dim: int
    paired: bool = False

    def indices(self, size: int, index: int, tp: int) -> torch.Tensor:
        """The positions along ``dim`` (of ``size``) that model rank ``index``
        of ``tp`` holds, in the order it holds them."""
        if self.paired:
            half, n = size // 2, size // 2 // tp
            lo = torch.arange(index * n, (index + 1) * n)
            return torch.cat([lo, lo + half])
        n = size // tp
        return torch.arange(index * n, (index + 1) * n)


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
    """The model axis must divide each gated block's hidden width (each half
    of the 2·hidden expand is split) and each scale's graph count.
    ValueError where it does not."""
    for hd in model.hidden_dims:
        if hd % tp:
            raise ValueError(f"hidden_dim {hd} (each half of 2*hidden {2 * hd}) % tp {tp} != 0")
    for g in model.ngraphs:
        if g % tp:
            raise ValueError(f"ngraphs {g} % tp {tp} != 0")


def spec_for_param(name: str, leaf: torch.Tensor) -> Placement | None:
    """The placement of one parameter by its dotted name (the port's names
    mirror flax's; a conv's ``weight`` is flax's ``kernel``): expand by
    output channel (paired halves), depthwise by channel (the same pairs),
    project by input channel; ``alphaCGD``/``betaCGD`` (iters, G) by graph;
    ``ro*``/``gamma*``/``muys*`` (G,) and ``multiM``/``stats_*`` (G, F) by
    graph. Anything else (None) is whole on every rank. The same rules
    place Adam's moments, which have their parameter's shape."""
    names = name.split(".")
    last, parent = names[-1], names[-2] if len(names) > 1 else ""
    ndim = leaf.ndim
    if last == "weight":
        if parent == "channels_linear_op" and ndim == 4 and leaf.shape[2:] == (1, 1):
            return Placement(0, paired=True)  # 1×1 expand (2H, C, 1, 1): output
        if parent == "channels_local_linear_op" and ndim == 4 and leaf.shape[1] == 1:
            return Placement(0, paired=True)  # depthwise (2H, 1, 3, 3): channel
        if parent == "project_out" and ndim == 4:
            return Placement(1)  # 1×1 project (C, H, 1, 1): input
        return None
    if last in _PER_GRAPH_ITER and ndim == 2:
        return Placement(1)  # (n_iters, G)
    if last in _PER_GRAPH_1D and ndim == 1:
        return Placement(0)  # (G,)
    if (last == "multiM" or last.startswith("stats_")) and ndim == 2:
        return Placement(0)  # (G, F)
    return None


def param_shardings(model: nn.Module) -> dict[str, Placement | None]:
    """``spec_for_param`` of every parameter, by name."""
    return {n: spec_for_param(n, p) for n, p in model.named_parameters()}


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


def _owner(model: nn.Module, name: str, kinds) -> str | None:
    """The longest prefix of ``name`` that names a module of ``kinds``."""
    parts = name.split(".")
    for k in range(len(parts) - 1, 0, -1):
        if isinstance(model.get_submodule(".".join(parts[:k])), kinds):
            return ".".join(parts[:k])
    return None


def shard_train_state(state, mesh: Mesh) -> None:
    """Cut a (single-device layout) train state to this rank's slices in
    place: every parameter ``spec_for_param`` places, its Adam moments where
    the optimizer has them, and the split modules told their place
    (``ModelShard``). NotImplementedError for a placed parameter outside a
    ``LocalGatedLinearBlock`` or ``MixtureGTVGLR`` (the pixel family's and
    the ablation solvers' graphs are not split yet). Nothing at tp = 1."""
    if mesh.tp == 1:
        return
    model = state.model
    kinds = _split_modules()
    shard = model_shard(mesh)
    placed = {n: pl for n, pl in param_shardings(model).items() if pl is not None}
    for name in placed:
        if _owner(model, name, kinds) is None:
            raise NotImplementedError(
                f"tensor_parallel={mesh.tp}: {name} has no split module (ROADMAP queue 1, "
                "the port's list of what is left, item 1)")
    for mod in model.modules():
        if isinstance(mod, kinds):
            mod.tp = shard
    params = dict(model.named_parameters())
    for name, pl in placed.items():
        p = params[name]
        idx = pl.indices(p.shape[pl.dim], shard.index, shard.size).to(p.device)
        with torch.no_grad():
            p.data = p.data.index_select(pl.dim, idx).contiguous()
        st = state.optimizer.state.get(p, {})
        for key in ("exp_avg", "exp_avg_sq"):
            if key in st:
                st[key] = st[key].index_select(pl.dim, idx).contiguous()
        owner = model.get_submodule(name.rpartition(".")[0])
        if hasattr(owner, "folded"):  # a conv: its variant's factor reads the whole kernel
            owner.shard = (pl, shard)
            if owner.groups > 1:  # the depthwise conv: one group a channel
                owner.groups = p.shape[0]


def model_shard(mesh: Mesh) -> ModelShard:
    """This rank's place on the mesh's model axis."""
    return ModelShard(mesh.model_group, mesh.model_index, mesh.tp)


def gather_full(t: torch.Tensor, pl: Placement, shard: ModelShard) -> torch.Tensor:
    """The whole tensor from every model rank's slice ``t``, on every rank
    (each calls it), with a gradient: each rank writes its slice into zeros
    and the model group all-reduces them (any backend takes an all-reduce;
    its backward is an all-reduce, the adjoint)."""
    shape = list(t.shape)
    shape[pl.dim] *= shard.size
    idx = pl.indices(shape[pl.dim], shard.index, shard.size).to(t.device)
    full = t.new_zeros(shape).index_copy(pl.dim, idx, t)
    return dist_fn.all_reduce(full, group=shard.group)


def local_part(full: torch.Tensor, pl: Placement, shard: ModelShard) -> torch.Tensor:
    """This rank's slice of a whole tensor."""
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
    whole = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and spec_for_param(n, p) is None]
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

