"""The kernel wrappers as ``torch.library`` operators, ``torch.ops.irdu.*``.

A kernel launch is a ctypes call on raw pointers, which a trace cannot see
or run: ``torch.export`` and ``torch.compile`` trace with fake tensors,
which have no data pointer. So every wrapper in ``ops/`` (K1-K9, K6 as K6a
and K6b) is also one operator of the ``irdu`` namespace, defined with an
explicit schema next to the wrapper (``define``):

  * its CPU implementation is the kernel's plain version and its CUDA
    implementation the wrapper's launch, which counts ``.launches``; both
    are the wrapper's own untraced path, so an artifact that runs the
    operator launches exactly what an eager call launches;
  * its fake implementation gives the output's shape, dtype and device, so
    that the trace records the call as one node.

Only a traced call goes through the operator (``tracing``); an eager call
takes the wrapper's path as before: the plain version on the CPU (where
training's autograd runs) and the launch on the card. The library is built
at the first CUDA launch, as before, so importing the operators needs no
nvcc. ``load_all`` imports every wrapper module, which registers the
operators, without importing any model code: an exported artifact needs
these registrations to load.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "irdu"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")  # kept alive: dropping it unregisters
OP_MODULES = ("block_stack", "edge_weights", "fused_step", "gated_block", "pixel_nhwc",
              "pixel_unroll", "solver_unroll", "system_matvec")


def tracing() -> bool:
    """Whether the call is being traced by ``torch.export`` or ``torch.compile``."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def define(schema: str, impl, fake):
    """Register ``irdu::<schema>``: ``impl`` (the wrapper's untraced path,
    called with the schema's arguments in order) on CPU and CUDA tensors,
    ``fake`` for traces. Returns the operator."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    for key in ("CPU", "CUDA"):
        _LIBRARY.impl(name, impl, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def flat_deltas(deltas) -> list[int]:
    """A window's (dh, dw) offsets as the flat ``int[]`` an operator takes."""
    return [int(v) for d in deltas for v in d]


def window(flat) -> tuple[tuple[int, int], ...]:
    """The inverse of ``flat_deltas``."""
    return tuple(zip(flat[::2], flat[1::2]))


def load_all() -> None:
    """Import every wrapper module, which registers its operator."""
    for name in OP_MODULES:
        importlib.import_module(f"irdu_tpu_torch.ops.{name}")
