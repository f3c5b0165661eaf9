"""The port's tiled inference (``parallel/spatial.py``, ``predict --tile``)
against the JAX package's ``_tile_grid`` and ``tiled_forward``: the grid,
a toy forward (exactly), and the micro snapshot carried across (f32)."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models.flagship import flagship_micro_config
from irdu_tpu.parallel import spatial as jax_spatial
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch import predict
from irdu_tpu_torch.parallel import spatial


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them as fast, and
    the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size,tile,halo", [
    (96, 32, 64), (100, 32, 8), (512, 512, 64), (2048, 512, 64), (31, 64, 16)])
def test_tile_grid_is_jax(size, tile, halo):
    grid = spatial._tile_grid(size, tile, halo)
    assert grid == jax_spatial._tile_grid(size, tile, halo)
    covered = [c for c0, c1, _, _ in grid for c in range(c0, c1)]
    assert covered == list(range(size))  # the cores partition the axis


def _toy_forward(batch):
    """A forward that sees position and neighbours: a 5x5 box blur (zero
    pad) plus a ramp in the row index, so a tile's offset and halo show."""
    b, h, w, c = batch.shape
    p = np.pad(batch, ((0, 0), (2, 2), (2, 2), (0, 0)))
    blur = sum(p[:, i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25.0
    return (blur + 0.01 * np.arange(h, dtype=np.float32)[None, :, None, None]).astype(np.float32)


@pytest.mark.parametrize("h,w,tile,halo", [(96, 80, 32, 64), (70, 53, 32, 8), (40, 40, 64, 16),
                                           (100, 36, 48, 0)])
def test_tiled_forward_is_jax_on_a_toy_forward(h, w, tile, halo):
    img = np.random.RandomState(h + w).rand(h, w, 3).astype(np.float32)
    ours = spatial.tiled_forward(_toy_forward, img, tile=tile, halo=halo)
    ref = jax_spatial.tiled_forward(_toy_forward, img, tile=tile, halo=halo)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_tiled_forward_takes_a_tensor_forward():
    img = np.random.RandomState(3).rand(70, 53, 3).astype(np.float32)
    ours = spatial.tiled_forward(lambda b: torch.from_numpy(_toy_forward(b)), img,
                                 tile=32, halo=8)
    np.testing.assert_array_equal(ours, jax_spatial.tiled_forward(_toy_forward, img,
                                                                  tile=32, halo=8))


@pytest.fixture(scope="module")
def micro_models():
    """JAX's micro model (eager; a window seen before is answered from a
    cache: with a halo that covers the image every tile reads the same
    window) and the port's, the same snapshot."""
    params = jax_load(predict.DEFAULT_WEIGHTS["micro"], dtype=jnp.float32)
    model = JaxFlagship(**flagship_micro_config())
    seen = {}

    def jax_fwd(b):
        key = (b.shape, b.tobytes())
        if key not in seen:
            seen[key] = np.asarray(model.apply(params, jnp.asarray(b)))
        return seen[key]

    return jax_fwd, predict.load_model(device="cpu", name="micro")


def test_micro_tiled_forward_matches_jax(micro_models):
    """The micro snapshot, 96x80 in tiles of 32 (halo 64), on each package's
    tiler with each package's model: within 1e-3."""
    jax_fwd, model = micro_models
    noisy = np.random.RandomState(5).rand(96, 80, 3).astype(np.float32)
    ours = spatial.tiled_forward(predict.batch_forward(model), noisy, tile=32, halo=64)
    ref = jax_spatial.tiled_forward(jax_fwd, noisy, tile=32, halo=64)
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)


def test_denoise_tile_is_the_tiler(micro_models):
    """predict.denoise(tile=) is tiled_forward with a 64-pixel halo, clamped;
    a halo that covers the image gives the whole-image result."""
    _, model = micro_models
    noisy = np.random.RandomState(6).rand(40, 56, 3).astype(np.float32)
    got = predict.denoise(model, noisy, tile=16)
    want = np.clip(spatial.tiled_forward(predict.batch_forward(model), noisy, tile=16,
                                         halo=64), 0, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, predict.denoise(model, noisy), atol=1e-5, rtol=0)


def test_cli_tile(tmp_path, capsys):
    """--tile runs the CLI through the tiler and reports it."""
    from PIL import Image

    src = tmp_path / "clean.png"
    Image.fromarray((np.random.RandomState(7).rand(40, 48, 3) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    predict.main(["--model", "micro", "--input", str(src), "--sigma", "25", "--tile", "32",
                  "--output", str(out)], device="cpu")
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["tile"] == 32 and report["shape"] == [40, 48]
    assert np.asarray(Image.open(out)).shape == (40, 48, 3)
