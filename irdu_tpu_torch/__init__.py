"""irdu_tpu_torch — the PyTorch/CUDA port of irdu_tpu for NVIDIA Hopper.

Module names mirror the JAX package so each piece has an obvious
counterpart (``irdu_tpu_torch.solvers.gtv_glr`` ↔ ``irdu_tpu.solvers.gtv_glr``).
The package imports torch and numpy only; the JAX package is the reference
it is tested against, never a dependency. Hand-written CUDA kernels live
under ``kernels/csrc`` and are built with nvcc at first use
(``kernels/build.py``); every kernel wrapper runs its plain PyTorch version
for CPU tensors and launches the kernel for CUDA tensors, or raises where
autograd would record the launch; a traced call (``torch.export``) goes
through the same wrapper as a ``torch.ops.irdu`` operator
(``kernels/library.py``), which ``deploy.py``'s artifacts call. ``train/`` trains the models on the plain
versions with autograd, as the JAX package trains on its jnp path.
"""
