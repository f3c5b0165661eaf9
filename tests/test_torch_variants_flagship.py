"""The flagship's ``conv_variant`` on a small flagship against the JAX
package in f32 (JAX's parameters and "spectral" collection carried across);
a file of its own so that a worker per file runs it beside
test_torch_variants.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.utils.weights import params_to_torch
from test_torch_variants import one_torch_thread, SMALL, TOL, VARIANTS, _variables


@pytest.mark.parametrize("variant", VARIANTS)
def test_small_flagship_variant_matches_jax(variant):
    """A small flagship with every encoder/decoder conv under the variant
    (the solvers plain), f32, against JAX's NHWC path."""
    x = np.random.RandomState(4).rand(1, 32, 48, 3).astype(np.float32)
    jm = JaxFlagship(conv_variant=variant, **SMALL)
    v = _variables(jm, np.zeros_like(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    port = AbstractMultiScaleGraphFilter(conv_variant=variant, **SMALL)
    params_to_torch(v, port)
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
