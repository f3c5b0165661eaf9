"""The port's natural-image eval (``irdu_tpu_torch/eval/natural.py``) against
the JAX package's: the noisy-input rows of its result files (which cover the
PNG reader, the masks, the noise, the pad and the rounding), the masks by the
JAX script's rule, one image through the micro snapshot on both sides, the
CLI's rows, the snapshot list and the baselines' constructions against the
JAX scripts', and a row of each family the port serves since GLR boosting
and the baselines."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irdu_tpu.eval import harness as jax_harness
from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.models.flagship import flagship_micro_config
from irdu_tpu.utils.weights import load_params_npz as jax_load
from irdu_tpu_torch.eval import harness, natural
from irdu_tpu_torch.predict import (
    BASELINES,
    DEFAULT_WEIGHTS,
    batch_forward,
    build_model,
    load_model,
)
from irdu_tpu_torch.utils.weights import params_from_torch, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "artifacts", "natural_eval")
# where each sigma's noisy-input row was written by the JAX script: the sigma-25
# sweep's file, and the logs of the single-snapshot sigma-15 and sigma-50 runs
NOISY_ROWS = {25.0: "artifacts/natural_eval/results_sigma25.jsonl",
              15.0: "artifacts/round5_eval/nat_s15.log",
              50.0: "artifacts/round5_eval/nat_s50.log"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def natural_set():
    return natural.load_set()


def _jax_noisy_row(sigma):
    with open(os.path.join(REPO, NOISY_ROWS[sigma])) as fh:
        row = json.loads(fh.readline())
    assert row["snapshot"] == "noisy-input"
    return row


@pytest.mark.parametrize("sigma", [25.0, 15.0, 50.0])
def test_noisy_input_rows_are_jax(natural_set, sigma):
    images, masks = natural_set
    assert [im.shape for im in images] == [(66, 484, 3), (124, 143, 3), (157, 483, 3),
                                           (470, 235, 3)]
    ours, ref = natural.noisy_row(images, masks, sigma), _jax_noisy_row(sigma)
    assert abs(ours["psnr"] - ref["psnr"]) <= 1e-9
    assert abs(ours["masked_psnr"] - ref["masked_psnr"]) <= 1e-9


def test_masks_follow_the_jax_rule(natural_set):
    """``_true`` → ``_suspect``, > 127, as PIL reads the masks; None where a
    mask file is missing."""
    _, masks = natural_set
    for i, stem in enumerate(("img01", "img02", "img03", "img04")):
        ref = np.asarray(Image.open(os.path.join(DATA, "masks", f"{stem}_suspect.png"))) > 127
        assert masks[i].dtype == bool and np.array_equal(masks[i], ref)
    index = os.path.join(DATA, "index.csv")
    assert harness.load_masks(index, os.path.join(DATA, "images")) == [None] * 4


def test_one_image_through_micro_matches_jax(natural_set):
    """The 124x143 image (padded to 128x192) through the micro snapshot in
    f32, the port on the CPU against JAX's jnp path: PSNR and masked PSNR
    within 1e-3 dB."""
    images, masks = natural_set
    img, mask = [images[1]], [masks[1]]
    params = jax_load(DEFAULT_WEIGHTS["micro"], dtype=jnp.float32)
    jax_model = JaxFlagship(**flagship_micro_config())
    ref = jax_harness.evaluate_pairs(
        lambda b: np.asarray(jax_model.apply(params, jnp.asarray(b))), img, 25.0,
        bucket=64, masks=mask)
    ours = harness.evaluate_pairs(batch_forward(load_model(device="cpu", name="micro")),
                                  img, 25.0, bucket=64, masks=mask)
    assert abs(ours["mean_psnr"] - ref["mean_psnr"]) <= 1e-3
    assert abs(ours["mean_masked_psnr"] - ref["mean_masked_psnr"]) <= 1e-3
    assert ours["mean_psnr"] > 21.0  # the snapshot denoises (noisy input: ~20.6 dB)


def test_cli_rows_have_the_jax_keys(tmp_path, capsys):
    """One snapshot through the CLI on the CPU, on a copy of the set cut to
    its 124x143 image: the noisy row, the snapshot's row with the keys of
    ``results_sigma25.jsonl``, the summary line, and the rows appended to
    ``--out``."""
    data = tmp_path / "set"
    for sub in ("images", "masks"):
        (data / sub).mkdir(parents=True)
    (data / "images" / "img02_true.png").write_bytes(
        (Path(DATA) / "images" / "img02_true.png").read_bytes())
    (data / "masks" / "img02_suspect.png").write_bytes(
        (Path(DATA) / "masks" / "img02_suspect.png").read_bytes())
    (data / "index.csv").write_text("index,path,height,width,nchannels\n"
                                    "0,img02_true.png,124,143,3\n")
    out = tmp_path / "rows.jsonl"
    natural.main(["--data", str(data), "--model", "micro", "--weights",
                  DEFAULT_WEIGHTS["micro"], "--out", str(out)], device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[0]["snapshot"] == "noisy-input"
    with open(os.path.join(DATA, "results_sigma25.jsonl")) as fh:
        jax_keys = [list(json.loads(ln)) for ln in fh][1]
    assert list(lines[1]) == jax_keys and lines[1]["snapshot"] == "micro_synthetic_2050.npz"
    assert len(lines[1]["per_image"]) == 1 and lines[1]["psnr"] > lines[0]["psnr"]
    assert lines[2]["results"] == [lines[1]]
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == [lines[1]]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_snapshots_and_baselines_are_the_jax_scripts():
    """The snapshot list is JAX's, in its order (a snapshot not in the tree,
    swinir's, skipped as there); the baselines are built as both JAX eval
    scripts build them."""
    script = _jax_script("eval_natural_benchmark")
    assert natural.SNAPSHOTS == [(n, os.path.basename(p)) for n, p in script.SNAPSHOTS]
    assert BASELINES == script.BASELINES
    with open(os.path.join(REPO, "scripts", "psnr_vs_throughput.py")) as fh:
        tree = ast.parse(fh.read())
    curve = [ast.literal_eval(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and any(getattr(t, "id", None) == "BASELINES" for t in n.targets)]
    assert curve == [BASELINES]
    assert not os.path.exists(os.path.join(natural.WEIGHTS, "swinir_synthetic_2050.npz"))


@pytest.mark.parametrize("family", ["boosting", "drunet", "dncnn", "restormer", "swinir"])
def test_unported_families_raise(natural_set, family, tmp_path):
    """Each family the port did not serve before GLR boosting and the
    baselines now yields a row on the CPU: its snapshot (SwinIR, which has
    none, a seeded one written by ``save_params_npz``) in f32 at its
    published width, on a 16x24 crop of the 124x143 image (bucket 8), with
    the keys of JAX's rows."""
    images, masks = natural_set
    img, mask = [images[1][40:56, 60:84]], [masks[1][40:56, 60:84]]
    weights = DEFAULT_WEIGHTS.get(family)
    if weights is None:
        torch.manual_seed(0)
        weights = str(tmp_path / "swinir.npz")
        save_params_npz(weights, params_from_torch(build_model(family)))
    row = natural.snapshot_row(family, weights, img, mask, 25.0, device="cpu", bucket=8)
    with open(os.path.join(DATA, "results_sigma25.jsonl")) as fh:
        jax_keys = [list(json.loads(ln)) for ln in fh][1]
    assert list(row) == jax_keys and row["model"] == family
    assert len(row["per_image"]) == 1 and np.isfinite(row["psnr"]) and row["psnr"] > 5.0
    assert (family, os.path.basename(weights)) in natural.SNAPSHOTS or family == "swinir"
