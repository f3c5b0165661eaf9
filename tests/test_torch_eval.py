"""The port's eval protocol against the JAX package's on the same numpy
inputs: the synthetic val set, the eval noise, the pad, the metrics, both
harnesses (on one numpy forward, and with the micro snapshot carried from
JAX's model) and the curve's variants."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.data import degradations as jax_degradations
from irdu_tpu.data import synthetic as jax_synthetic
from irdu_tpu.eval import harness as jax_harness
from irdu_tpu.eval import metrics as jax_metrics
from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models.flagship import flagship_micro_config
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.data import degradations, synthetic
from irdu_tpu_torch.eval import curve, harness, metrics
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, batch_forward, load_model

SIGMA = 25.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them as fast, and
    the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,h,w", [(0, 37, 53), (1, 96, 128), (42, 384, 512)])
def test_make_synthetic_image_is_jax_byte_for_byte(seed, h, w):
    ours = synthetic.make_synthetic_image(np.random.RandomState(seed), h, w)
    ref = jax_synthetic.make_synthetic_image(np.random.RandomState(seed), h, w)
    assert ours.dtype == np.uint8 and np.array_equal(ours, ref)


def test_synthetic_val_set_is_the_corpus_draw():
    """scripts/run_convergence_tpu.py's build_corpus: RandomState(42), 24
    train images of random size drawn first, then 6 val images at 384x512."""
    rng = np.random.RandomState(42)
    for _ in range(24):
        h, w = int(rng.randint(420, 520)), int(rng.randint(420, 520))
        jax_synthetic.make_synthetic_image(rng, h, w)
    ref = [jax_synthetic.make_synthetic_image(rng, 384, 512) for _ in range(6)]
    ours = synthetic.synthetic_val_set()
    assert len(ours) == 6
    assert all(a.shape == (384, 512, 3) and np.array_equal(a, b) for a, b in zip(ours, ref))


@pytest.mark.parametrize("seed", [2204, 7])
def test_eval_noise_is_jax(seed):
    shape = (5, 7, 3)
    np.testing.assert_array_equal(degradations.eval_noise(shape, SIGMA, seed),
                                  jax_degradations.eval_noise(shape, SIGMA, seed))
    rs, jrs = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):  # one stream across a dataset
        np.testing.assert_array_equal(degradations.eval_noise(shape, 15.0, random_state=rs),
                                      jax_degradations.eval_noise(shape, 15.0, random_state=jrs))


@pytest.mark.parametrize("mode,lam", [
    ("addictive_noise", 25.0), ("additive_noise_scale", 15.0),
    ("vary_addictive_noise", ([1.0, 10.0, 25.0], [0.2, 0.2, 0.6])), ("none", 0.0)])
def test_add_noise_is_jax(mode, lam):
    patch = np.random.RandomState(1).rand(6, 9, 3).astype(np.float32)
    ours = degradations.add_noise(patch, mode, lam, np.random.RandomState(3))
    ref = jax_degradations.add_noise(patch, mode, lam, np.random.RandomState(3))
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("h,w,factor", [(37, 53, 16), (48, 64, 16), (100, 70, 64), (5, 3, 4)])
def test_pad_to_multiple_is_jax(h, w, factor):
    img = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
    ours, oh, ow = harness.pad_to_multiple(img, factor)
    ref, rh, rw = jax_harness.pad_to_multiple(img, factor)
    assert (oh, ow) == (rh, rw) == (h, w)
    np.testing.assert_array_equal(ours, ref)


def test_metrics_are_jax():
    rs = np.random.RandomState(5)
    a = rs.randint(0, 256, (40, 50, 3)).astype(np.float32)
    b = np.clip(a + rs.normal(0, 9, a.shape), 0, 255).round().astype(np.float32)
    assert metrics.ssim_255(a, b) == jax_metrics.ssim_255(a, b)
    assert metrics.ssim_255(a[..., 0], b[..., 0]) == jax_metrics.ssim_255(a[..., 0], b[..., 0])
    assert metrics.psnr_unit(a / 255, b / 255 + 0.01) == jax_metrics.psnr_unit(a / 255,
                                                                             b / 255 + 0.01)
    assert metrics.psnr_255(a, b) == jax_metrics.psnr_255(a, b)
    assert metrics.psnr_unit(a, a) == float("inf")


def _toy_forward(batch):
    """A numpy forward that sees the pad: a 3x3 box blur over the whole
    padded frame, shrunk towards 0.5."""
    p = np.pad(batch, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = batch.shape[1:3]
    blur = sum(p[:, i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9.0
    return (0.9 * blur + 0.05).astype(np.float32)


def _images():
    """5 images: two shapes that are not multiples of 64 in one bucket, one
    in another; 5 images make a short batch of 4."""
    rs = np.random.RandomState(11)
    shapes = [(70, 90), (100, 120), (70, 90), (48, 64), (66, 100)]
    return [synthetic.make_synthetic_image(rs, h, w) for h, w in shapes]


@pytest.mark.parametrize("bucket", [None, 64])
def test_evaluate_pairs_is_jax(bucket):
    images = _images()
    masks = [None, np.zeros(images[1].shape[:2], bool), None, None, None]
    masks[1][:10] = True
    kw = dict(bucket=bucket, compute_ssim=True, masks=masks)
    ours = harness.evaluate_pairs(_toy_forward, images, SIGMA, **kw)
    ref = jax_harness.evaluate_pairs(_toy_forward, images, SIGMA, **kw)
    for key in ("psnr", "masked_psnr", "ssim"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-6)
    assert ours["mean_psnr"] == pytest.approx(ref["mean_psnr"], abs=1e-6)


def test_evaluate_pairs_takes_a_tensor_forward():
    images = _images()[:2]
    ours = harness.evaluate_pairs(lambda b: torch.from_numpy(_toy_forward(b)), images, SIGMA)
    ref = jax_harness.evaluate_pairs(_toy_forward, images, SIGMA)
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("device_metrics", [False, True])
def test_evaluate_pairs_batched_is_jax(device_metrics):
    """Bucket crop and the short batch's fill against JAX's host path; the
    port's device scorer is f64 and equals the host path."""
    images = _images()
    calls = []

    def forward(batch):
        calls.append(batch.shape)
        out = _toy_forward(batch)
        return torch.from_numpy(out) if device_metrics else out

    ours = harness.evaluate_pairs_batched(forward, images, SIGMA, batch_size=4,
                                          device_metrics=device_metrics)
    ref = jax_harness.evaluate_pairs_batched(_toy_forward, images, SIGMA, batch_size=4)
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], rtol=0, atol=1e-6)
    assert ours["mean_psnr"] == pytest.approx(ref["mean_psnr"], abs=1e-6)
    # buckets (128, 128) with 4 images and (64, 64) with 1: each run once to
    # warm up, then as one batch of 4 (the second filled with its one image)
    assert calls == [(4, 128, 128, 3), (4, 64, 64, 3)] * 2
    assert ours["mp_per_s"] > 0


def test_score_batch_is_the_host_protocol():
    """The device scorer on a padded batch against img_as_ubyte + psnr_255
    on each cropped image, including the rounding at .5 boundaries."""
    rs = np.random.RandomState(4)
    restored = rs.rand(3, 32, 48, 3).astype(np.float32) * 1.2 - 0.1
    restored[0, 0, 0] = np.float32(0.5 / 255)  # a tie: rint goes to the even value
    truth = rs.randint(0, 256, (3, 32, 48, 3)).astype(np.float32)
    hs, ws = np.array([32, 20, 7]), np.array([48, 33, 48])
    got = harness.score_batch(torch.from_numpy(restored), torch.from_numpy(truth),
                              torch.from_numpy(hs), torch.from_numpy(ws)).numpy()
    for j in range(3):
        h, w = hs[j], ws[j]
        q = metrics.img_as_ubyte(np.clip(restored[j, :h, :w], 0, 1)).astype(np.float32)
        assert got[j] == pytest.approx(metrics.psnr_255(truth[j, :h, :w], q), abs=1e-9)


@pytest.fixture(scope="module")
def micro_pair():
    """The micro snapshot on JAX's model and, carried across, on the port's (f32)."""
    params = jax_load(DEFAULT_WEIGHTS["micro"], dtype=jnp.float32)
    model = JaxFlagship(**flagship_micro_config())
    # eager: at one small shape compiling the whole model costs more than running it
    return ((lambda b: np.asarray(model.apply(params, jnp.asarray(b)))),
            load_model(device="cpu", name="micro"))


def test_micro_snapshot_through_both_harnesses(micro_pair):
    """The port's micro model and JAX's on the same two 48x64 images, through
    each package's harness (bucket 64 pads them to 64x64): restored arrays
    within 1e-3, PSNR within 0.01 dB, sequential and batched."""
    jax_fwd, model = micro_pair
    images = _images()[3:4] * 2
    port_fwd = batch_forward(model)
    noisy, _, _ = harness.pad_to_multiple(
        (images[0] / 255.0 + degradations.eval_noise(images[0].shape, SIGMA)).astype(np.float32), 64)
    np.testing.assert_allclose(port_fwd(noisy[None]).numpy(), jax_fwd(noisy[None]), atol=1e-3)
    ours = harness.evaluate_pairs(port_fwd, images, SIGMA, bucket=64)
    ref = jax_harness.evaluate_pairs(jax_fwd, images, SIGMA, bucket=64)
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], rtol=0, atol=0.01)
    batched = harness.evaluate_pairs_batched(port_fwd, images, SIGMA, batch_size=4,
                                             device_metrics=True)
    np.testing.assert_allclose(batched["psnr"], ref["psnr"], rtol=0, atol=0.01)


@pytest.mark.parametrize("name,fs,want", [
    ("flagship", None, ["flagship-cg3", "flagship-cg1"]),
    ("lite", (1, 2, 3), ["lite-cg3", "lite-cg1", "lite-cg3-fs123", "lite-cg1-fs123"]),
    ("pixel", None, ["pixel"])])
def test_curve_variants_are_the_scripts(name, fs, want):
    """scripts/psnr_vs_throughput.py's variants and tags."""
    assert [curve.variant_tag(name, k, f) for k, f in curve.variants(name, fs)] == want


def test_curve_rows_on_the_cpu(micro_pair, monkeypatch):
    """curve.run's rows on two small images: each variant's PSNR is the
    harness's, the gap is to cg3, the throughput is timed (here at 64x64)."""
    _, model = micro_pair
    monkeypatch.setattr(curve, "SIDE", 64)
    images = _images()[3:5]
    rows = curve.run("micro", device="cpu", images=images, reps=1)
    assert [r["variant"] for r in rows] == ["micro-cg3", "micro-cg1"]
    ref = harness.evaluate_pairs(batch_forward(model), images, SIGMA, bucket=64)
    assert rows[0]["psnr"] == pytest.approx(ref["mean_psnr"], abs=1e-9)
    assert rows[0]["psnr_delta_vs_full"] == 0.0
    assert rows[1]["psnr_delta_vs_full"] == pytest.approx(rows[1]["psnr"] - rows[0]["psnr"])
    assert all(r["mp_per_s"] > 0 for r in rows)
