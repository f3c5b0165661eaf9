"""The port's serving export (``irdu_tpu_torch/deploy.py``) against the JAX
package's model: a tiny flagship from JAX's init exported on the CPU in f32,
reloaded in a process that imports no model code, against JAX's forward and
the port's eager model; its graph, one ``irdu::`` node a kernel call; a small
pixel model; int8 pointwise weights; the CLI; and the errors."""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.utils import weights as jax_weights
from irdu_tpu_torch import deploy
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.predict import DEFAULT_WEIGHTS
from irdu_tpu_torch.utils.weights import params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_deploy.py's TINY flagship
TINY = dict(dims=(8, 12, 16, 24), hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4),
            num_blocks=(1, 1, 1, 1), num_blocks_out=1)
SIDE = 32
# the kernel calls of a 32x32 TINY request on the card's route: every block
# list at C <= 64 on K3 (4 encoder, 3 decoder, 1 refining), per scale K2 once
# and K1 once; the plain unroll traced instead had 10,006 graph nodes
TINY_OPS = {"edge_weights_chw": 8, "fused_block_stack": 8, "gg_unroll_chw": 4}
PIXEL_TINY = dict(n_graphs=4, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
                  feature_num_refinement=1, use_pallas_solver=True, use_nhwc_solver=True)
PIXEL_OPS = {"edge_weights_chw": 1, "pixel_segment_nhwc": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """JAX's TINY flagship and its init, the port's model carrying them, a
    seeded input, and the f32 artifact."""
    jax_model = JaxFlagship(**TINY)
    x = np.random.RandomState(0).rand(1, SIDE, SIDE, 3).astype(np.float32)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros_like(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = AbstractMultiScaleGraphFilter(**TINY)
    params_to_torch(params, model)
    model.eval().requires_grad_(False)
    blob = deploy.export_forward(model, 1, SIDE, SIDE, dtype=torch.float32)
    return jax_model, params, model, x, blob


def test_artifact_runs_without_model_code_and_matches_jax(tiny, tmp_path):
    jax_model, params, model, x, blob = tiny
    path = tmp_path / "tiny.pt2"
    path.write_bytes(blob)
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from irdu_tpu_torch.deploy import load_exported\n"
        f"run = load_exported({str(path)!r})\n"
        f"y = run(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "print(run.input_shape, run.input_dtype, "
        "sorted(m for m in sys.modules if m.startswith('irdu_tpu_torch.models')))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == f"(1, {SIDE}, {SIDE}, 3) torch.float32 []"
    got = np.load(tmp_path / "y.npy")
    with torch.no_grad():
        eager = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, eager, atol=1e-6, rtol=0)
    ref = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_graph_holds_one_op_a_kernel_call(tiny):
    *_, blob = tiny
    run = deploy.load_exported(blob)
    assert run.meta["kernel_ops"] == TINY_OPS
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum(t.startswith("irdu.") for t in targets) == sum(TINY_OPS.values())
    # the plain unroll's box up-sample (repeat_interleave) is not in the graph
    assert not [t for t in targets if "repeat_interleave" in t]
    assert len(program.graph.nodes) < 2000


def test_pixel_model_exports_through_k2_and_k8(tmp_path):
    torch.manual_seed(0)
    model = MultiScaleSequenceDenoiser(**PIXEL_TINY).eval().requires_grad_(False)
    blob = deploy.export_forward(model, 1, 16, 48, dtype=torch.float32,
                                 path=str(tmp_path / "pixel.pt2"))
    assert (tmp_path / "pixel.pt2").read_bytes() == blob
    run = deploy.load_exported(str(tmp_path / "pixel.pt2"))
    assert run.meta["kernel_ops"] == PIXEL_OPS and run.input_shape == (1, 16, 48, 3)
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 16, 48, 3).astype(np.float32))
    with torch.no_grad():
        eager = model(x)
    torch.testing.assert_close(run(x), eager, atol=1e-6, rtol=0)


def _archive_weights(blob):
    """Bytes of the archive's weights and the dtypes its config gives them."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        names = [n for n in zf.namelist() if "/data/weights/" in n]
        nbytes = sum(zf.getinfo(n).file_size for n in names if not n.endswith(".json"))
        config = next(n for n in names if n.endswith("model_weights_config.json"))
        text = zf.read(config).decode()
    return nbytes, text


def test_int8_artifact_carries_int8_and_matches_jax_dequantized(tiny):
    jax_model, params, model, x, blob = tiny
    blob8 = deploy.export_forward(model, 1, SIDE, SIDE, dtype=torch.float32,
                                  pointwise_int8=True)
    run = deploy.load_exported(blob8)
    n_2d = sum(1 for leaf in jax.tree_util.tree_leaves_with_path(params["params"])
               if str(leaf[0][-1]) == "['kernel']" and leaf[1].ndim == 2)
    assert run.meta["int8"] and run.meta["int8_tensors"] == n_2d > 0
    assert run.meta["kernel_ops"] == TINY_OPS
    bytes8, config8 = _archive_weights(blob8)
    bytes32, _ = _archive_weights(blob)
    assert bytes8 < bytes32 and config8.count("weight_q") == n_2d
    # the eager model with JAX's quantize-then-dequantize weights
    deq = jax_weights.dequantize_pointwise(jax_weights.quantize_pointwise_int8(
        params["params"]), dtype=np.float32)
    ref_model = AbstractMultiScaleGraphFilter(**TINY)
    params_to_torch(deq, ref_model)
    with torch.no_grad():
        ref = ref_model.eval()(torch.from_numpy(x))
    torch.testing.assert_close(run(x), ref, atol=1e-3, rtol=0)


def test_cli_exports_a_snapshot(tmp_path, capsys):
    out = tmp_path / "micro.pt2"
    deploy.main(["--model", "micro", "--size", "32", "--cg-iters", "1", "--filter-scales",
                 "1,2,3", "--output", str(out)], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bytes"] == out.stat().st_size and line["input"] == [1, 32, 32, 3]
    assert line["dtype"] == "float32" and line["backend"] == "cpu"
    assert line["weights"] == DEFAULT_WEIGHTS["micro"] and not line["weight_int8"]
    meta = deploy.load_exported(str(out)).meta
    # filter scales 1-3: K2 and K1 for three scales; micro's blocks on K3 (C <= 64) and K4
    assert meta["kernel_ops"]["gg_unroll_chw"] == 3 and meta["kernel_ops"]["edge_weights_chw"] == 6
    assert meta["model"] == "micro" and meta["weights"] == "micro_synthetic_2050.npz"


def test_export_and_load_errors(tiny):
    model, blob = tiny[2], tiny[4]
    with pytest.raises(ValueError, match="/16"):
        deploy.export_forward(model, 1, 30, 32, dtype=torch.float32)
    run = deploy.load_exported(blob)
    with pytest.raises(ValueError, match="expected input"):
        run(torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="not an irdu_tpu_torch export"):
        deploy.load_exported(b"GARBAGE-BYTES")
    # the same archive tagged as exported on the card: refused without a CUDA device
    src, dst = zipfile.ZipFile(io.BytesIO(blob)), io.BytesIO()
    with zipfile.ZipFile(dst, "w") as zf:
        for name in src.namelist():
            data = src.read(name)
            if name.endswith(f"/extra/{deploy.META}"):
                data = json.dumps(dict(json.loads(data), device="cuda")).encode()
            zf.writestr(name, data)
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="exported for CUDA"):
        deploy.load_exported(dst.getvalue())
