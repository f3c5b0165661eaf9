"""The npz weight snapshots of the JAX package: load them and put them onto
the port's modules (``load_params_npz``, ``params_to_torch``), and take a
port model's parameters back to JAX's tree and write them in the same
format (``params_from_torch``, ``save_params_npz``), so that a model the
port trains is served by the port and by the JAX package alike.

Snapshot format (written by ``irdu_tpu.utils.weights.save_params_npz``):
keys are ``/``-joined flax parameter paths; a ``::bf16`` suffix marks a
bfloat16 leaf stored as its raw uint16 bits; int8 pointwise snapshots store
a 2-D kernel as ``<path>/__q8__`` (int8) plus ``<path>/__q8scale__`` (f32,
per output channel). This copy needs numpy and torch. The int8 scheme is
JAX's, bit for bit (``quantize_kernel_int8``): a symmetric per-output-channel
scale max|w|/127 (0 taken as 1), ``np.round``, clipped to ±127; dequantized
as ``q.astype(f32) * s``, then cast to the model's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Exact bfloat16 → float32: the bf16 bits are the high half of the f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 → the bfloat16 bits (uint16), rounded to nearest even, as
    ``ml_dtypes``' cast rounds them."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def quantize_kernel_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of a 2-D (1×1-conv) flax kernel
    (I, O): (q int8 (I, O), scale f32 (1, O)), JAX's arithmetic."""
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0, keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_pointwise_int8(tree: dict) -> dict:
    """Every 2-D ``kernel`` leaf as a {"__q8__": q, "__q8scale__": scale}
    dict; the other leaves as float32 numpy arrays (tensors copied to the
    host). ``dequantize_pointwise`` is the inverse."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        arr = _host(node)
        if name == "kernel" and arr.ndim == 2:
            q, s = quantize_kernel_int8(arr)
            return {"__q8__": q, "__q8scale__": s}
        return arr

    return walk(tree)


def dequantize_pointwise(tree: dict) -> dict:
    """Each {"__q8__", "__q8scale__"} dict as ``q.astype(f32) * scale``, the
    other leaves as float32 (cast to the model's dtype where they land)."""
    if "__q8__" in tree:
        return tree["__q8__"].astype(np.float32) * tree["__q8scale__"].astype(np.float32)
    return {k: dequantize_pointwise(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in tree.items()}


def _host(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        return node.detach().float().cpu().numpy()
    return np.asarray(node)


def load_params_npz(path: str, keep_int8: bool = False) -> dict:
    """Rebuild the nested params dict as float32 numpy arrays (bf16 leaves
    widened exactly). int8 pointwise kernels are dequantized
    (``dequantize_pointwise``) unless ``keep_int8``, which keeps their
    {"__q8__" int8, "__q8scale__" f32} dicts as stored."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith("::bf16"):
                key = key[: -len("::bf16")]
                arr = bf16_bits_to_f32(arr)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return _widen(out) if keep_int8 else dequantize_pointwise(out)


def _widen(node):
    """Every leaf as float32 but the int8 dicts' own."""
    if "__q8__" in node:
        return node
    return {k: _widen(v) if isinstance(v, dict) else v.astype(np.float32)
            for k, v in node.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_leaf(model: torch.nn.Module, owner: str, leaf: str) -> str:
    """The torch name of flax leaf ``leaf`` of module ``owner``: the
    module's ``FLAX_NAMES`` entry (a BatchNorm's ``scale`` is its ``weight``,
    its ``mean`` its ``running_mean``), else the leaf's own name."""
    try:
        mod = model.get_submodule(owner)
    except AttributeError:
        return leaf
    return getattr(mod, "FLAX_NAMES", {}).get(leaf, leaf)


def _stat_buffers(model: torch.nn.Module) -> dict:
    """The buffers a flax ``batch_stats`` collection sets (a BatchNorm's
    running mean and variance), by torch name, with their flax paths."""
    out = {}
    for owner, mod in model.named_modules():
        own = dict(mod.named_buffers(recurse=False))
        for flax_name, name in getattr(mod, "FLAX_NAMES", {}).items():
            if name in own:
                out[f"{owner}.{name}" if owner else name] = (
                    own[name], (owner.split(".") if owner else []) + [flax_name])
    return out


@torch.no_grad()
def params_to_torch(flax_params: dict, model: torch.nn.Module, spectral: dict | None = None) -> None:
    """Copy a nested flax params dict (optionally under a top-level
    ``"params"`` key) onto ``model``, the ``"spectral"`` collection's
    ``*_u`` vectors onto its buffers of the same names, and the
    ``"batch_stats"`` collection onto the BatchNorm running statistics.

    Module attribute names mirror the flax scope names, so a flax path
    ``a/b/c/kernel`` lands on ``model.a.b.c.weight`` through the owning
    module's ``kernel_to_torch`` (layout conversion); every other leaf
    lands on the parameter of the same name (``scaling_factor`` too), or of
    the name the owning module's ``FLAX_NAMES`` gives it.
    ``spectral``: the collection's tree (default: ``flax_params["spectral"]``
    when the dict holds both collections); its leaves are variables, not
    params, and ``a/b/c/kernel_u`` lands on the buffer ``a.b.c.kernel_u``.
    ``flax_params["batch_stats"]`` (next to "params"): ``a/bn/mean`` and
    ``a/bn/var`` land on ``a.bn.running_mean`` and ``running_var``. Raises
    KeyError on a flax leaf with no parameter or buffer, a parameter no leaf
    set, when a spectral tree is given a ``kernel_u`` buffer it does not
    set, and a running statistic that no batch_stats leaf sets (a model
    with BatchNorms needs the collection); ValueError on a shape
    mismatch."""
    tree = flax_params.get("params", flax_params)
    if spectral is None and "params" in flax_params:
        spectral = flax_params.get("spectral")
    named = dict(model.named_parameters())
    done = set()
    for path, arr in _flatten(tree):
        owner = ".".join(path[:-1])
        if path[-1] == "kernel":
            name = f"{owner}.weight" if owner else "weight"
            if name not in named:
                raise KeyError(f"flax leaf {'/'.join(path)} has no parameter {name}")
            value = model.get_submodule(owner).kernel_to_torch(torch.tensor(np.asarray(arr)))
        else:
            name = ".".join((*path[:-1], _torch_leaf(model, owner, path[-1])))
            if name not in named:
                raise KeyError(f"flax leaf {'/'.join(path)} has no parameter {name}")
            value = torch.tensor(np.asarray(arr))
        _copy(named[name], value, name)
        done.add(name)
    missing = sorted(set(named) - done)
    if missing:
        raise KeyError(f"parameters not set by the snapshot: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    stats = _stat_buffers(model)
    stats_tree = flax_params.get("batch_stats", {}) if "params" in flax_params else {}
    _copy_collection(model, stats_tree, {n: b for n, (b, _) in stats.items()}, "batch_stats",
                     "running statistics")
    if spectral is None:
        return
    buffers = {n: b for n, b in model.named_buffers() if n.endswith("kernel_u")}
    _copy_collection(model, spectral, buffers, "spectral", "spectral vectors")


def _copy_collection(model, tree: dict, buffers: dict, what: str, kind: str) -> None:
    """A variable collection's leaves onto ``buffers`` (torch name →
    buffer), each leaf named as ``params_to_torch`` names it; every buffer
    must be set."""
    done = set()
    for path, arr in _flatten(tree):
        name = ".".join((*path[:-1], _torch_leaf(model, ".".join(path[:-1]), path[-1])))
        if name not in buffers:
            raise KeyError(f"{what} leaf {'/'.join(path)} has no buffer {name}")
        _copy(buffers[name], torch.tensor(np.asarray(arr, np.float32)), name)
        done.add(name)
    missing = sorted(set(buffers) - done)
    if missing:
        raise KeyError(f"{kind} not set: {missing[:8]}{' ...' if len(missing) > 8 else ''}")


def _copy(dst: torch.Tensor, value: torch.Tensor, name: str) -> None:
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: snapshot shape {tuple(value.shape)} "
                         f"!= parameter shape {tuple(dst.shape)}")
    dst.copy_(value)


def _set(tree: dict, path, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


@torch.no_grad()
def params_from_torch(model: torch.nn.Module, spectral: bool | None = None) -> dict:
    """The reverse of ``params_to_torch``: JAX's variables tree of ``model``,
    {"params": ...} with flax names and layouts (``kernel_from_torch`` of
    each weight's module, ``FLAX_NAMES`` read backwards), as float32 numpy
    arrays (a bf16 model's values widened exactly); with ``spectral``
    (default: when the model has ``kernel_u`` buffers) also {"spectral":
    ...}, the u vectors; when the model has BatchNorms also {"batch_stats":
    ...}, their running statistics. The tree goes back onto the model
    through ``params_to_torch`` unchanged, and ``save_params_npz`` writes it
    as JAX's snapshot of the same model."""
    def host(t):
        return np.ascontiguousarray(t.detach().float().cpu().numpy())

    params: dict = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        path = owner.split(".") if owner else []
        if leaf == "weight" and hasattr(mod, "kernel_from_torch"):
            _set(params, path + ["kernel"], host(mod.kernel_from_torch(p)))
        else:
            flax = {v: k for k, v in getattr(mod, "FLAX_NAMES", {}).items()}
            _set(params, path + [flax.get(leaf, leaf)], host(p))
    tree = {"params": params}
    stats = _stat_buffers(model)
    if stats:
        tree["batch_stats"] = {}
        for b, path in stats.values():
            _set(tree["batch_stats"], path, host(b))
    buffers = [(n, b) for n, b in model.named_buffers() if n.endswith("kernel_u")]
    if spectral or (spectral is None and buffers):
        tree["spectral"] = {}
        for name, b in buffers:
            _set(tree["spectral"], name.split("."), host(b))
    return tree


def save_params_npz(path: str, tree: dict, dtype=None, int8_pointwise: bool = False) -> None:
    """Write a nested tree (numpy arrays or tensors; ``params_from_torch``
    gives one) in JAX's ``save_params_npz`` format: keys the ``/``-joined
    paths, ``np.savez_compressed``. ``dtype`` casts every leaf:
    ``torch.bfloat16`` (or "bfloat16") stores the bf16 bits as uint16 under
    ``<key>::bf16``, as JAX does; None keeps each leaf's dtype (a bf16
    tensor stored the same way). ``int8_pointwise`` stores every 2-D kernel
    as int8 and its f32 scale (``quantize_pointwise_int8``, from the leaves'
    values before any cast), which ``dtype`` leaves as they are."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if int8_pointwise:
        tree = quantize_pointwise_int8(tree)
    flat = {}
    for parts, arr in _flatten(tree):
        key = "/".join(parts)
        if parts[-1].startswith("__q8"):
            flat[key] = np.asarray(arr)
            continue
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu()
            if dtype is None and arr.dtype == torch.bfloat16:
                flat[key + "::bf16"] = arr.view(torch.int16).numpy().view(np.uint16)
                continue
            arr = arr.float().numpy() if arr.dtype == torch.bfloat16 else arr.numpy()
        arr = np.asarray(arr)
        if dtype == torch.bfloat16:
            flat[key + "::bf16"] = f32_to_bf16_bits(arr)
        elif dtype is not None:
            flat[key] = arr.astype(str(dtype).removeprefix("torch."))
        else:
            flat[key] = arr
    np.savez_compressed(path, **flat)
