"""The port's multi-GPU layer on the CPU, every multi-rank case from one
spawn of 4 gloo ranks (and sub-meshes of 2 of them), held against JAX's
CPU mesh and against one process.

Spatially sharded inference (``parallel/spatial.py``): ``_axis_windows``
and ``_tile_grid`` equal JAX's; ``sharded_tiled_forward`` on 2 ranks exact
with the identity at tests/test_spatial_windows.py's sizes and equal to
JAX's with its mean-3 stencil; ``halo_shard_forward`` on 2 and 4 ranks
equal to JAX's with a toy stencil at 256×48 and the uneven 250×41, and
with tests/test_parallel_sp.py's TINY flagship (f32, plain path) within
5e-3 of the port's whole-image forward (1e-5 on one rank).

Tensor and expert parallelism (``parallel/tensor.py``): the placement
rules on the real flagship tree equal JAX's ``spec_for_param`` leaf by leaf
(the same axis, JAX's 44/44/44/112 counts), the divisibility check, and
one train step of a tiny flagship (test_parallel_tp.py's widths, one block
a list) at tp = 2 (2 ranks) and, for each ``conv_variant``, at dp = 2 × tp
= 2 (4 ranks), against one process on the same global batch: the loss
within 1e-4 (JAX's dryrun bar), the gathered gradients within atol=5e-5,
rtol=1e-3, and the gathered updated parameters and Adam moments."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu.parallel import spatial as jax_spatial
from irdu_tpu.parallel.mesh import make_mesh as jax_mesh
from irdu_tpu.parallel.tensor import MODEL_AXIS as JAX_MODEL_AXIS
from irdu_tpu.parallel.tensor import spec_for_param as jax_spec_for_param
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter, flagship_config
from irdu_tpu_torch.parallel import spatial
from irdu_tpu_torch.parallel.mesh import make_mesh
from irdu_tpu_torch.parallel.tensor import check_tp_divisibility, param_shardings
from irdu_tpu_torch.predict import batch_forward

import torch_parallel_ranks as ranks

VARIANTS = ("plain", "spectral_norm", "non_expansive")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's ``mesh_job`` results, from one spawn of 4 ranks."""
    return ranks.spawn(ranks.mesh_job, 4, str(tmp_path_factory.mktemp("mesh")), VARIANTS)


@pytest.fixture(scope="module")
def runs(spawned):
    """{mesh size: rank 0's spatial results}; every rank of a mesh returns
    the same images."""
    res = [r["spatial"] for r in spawned]
    for world in (2, 4):
        for r in res[1:world]:
            for key in ("halo_toy", "halo_tiny"):
                for hw, img in r[world][key].items():
                    np.testing.assert_array_equal(img, res[0][world][key][hw])
    return res[0]


@pytest.fixture(scope="module")
def tp_runs(spawned):
    """{(mesh size, tp): every member rank's tensor results}: 2 × 2 on the 4
    ranks, 1 × 2 on ranks {0, 1}."""
    return {key: [r["tensor"][key] for r in spawned[:key[0]]] for key in ((2, 2), (4, 2))}


def _jax_toy(params, batch):
    x = jnp.pad(batch, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    box = sum(x[:, i:i + batch.shape[1], j:j + batch.shape[2]]
              for i in range(5) for j in range(5)) / 25.0
    return box + 0.1 * batch * batch


def _jax_mean3(params, batch):
    x = jnp.pad(batch, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    return sum(x[:, i:i + batch.shape[1], j:j + batch.shape[2]]
               for i in range(3) for j in range(3)) / 9.0


@pytest.mark.parametrize("size", [40, 48, 95, 96, 97, 128, 300, 513])
@pytest.mark.parametrize("step,halo", [(32, 32), (256, 32)])
def test_windows_equal_jax(size, step, halo):
    assert spatial._axis_windows(size, step, halo) == jax_spatial._axis_windows(size, step, halo)
    assert spatial._tile_grid(size, step, halo) == jax_spatial._tile_grid(size, step, halo)


@pytest.mark.parametrize("hw", ranks.IDENTITY_SIZES)
def test_sharded_tiled_identity_exact(runs, hw):
    np.testing.assert_array_equal(runs[2]["identity"][hw], ranks.seeded_image(*hw, 0))


def test_sharded_tiled_mean3_equals_jax(runs):
    img = ranks.seeded_image(48, 112, 1)
    ref = jax_spatial.sharded_tiled_forward(_jax_mean3, {}, img, jax_mesh(jax.devices()[:2]),
                                            tile=32, halo=32)
    np.testing.assert_allclose(runs[2]["mean3"], ref, atol=1e-6)
    whole = np.asarray(_jax_mean3({}, jnp.asarray(img[None])))[0]
    np.testing.assert_allclose(runs[2]["mean3"], whole, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("k,hw", list(enumerate(ranks.HALO_SHAPES)))
def test_halo_shard_toy_equals_jax(runs, world, k, hw):
    img = ranks.seeded_image(*hw, 2 + k)
    ref = jax_spatial.halo_shard_forward(_jax_toy, {}, img, jax_mesh(jax.devices()[:world]),
                                         halo=ranks.HALO)
    got = runs[world]["halo_toy"][hw]
    assert got.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_shard_tiny_flagship_near_whole(runs, world):
    """test_parallel_sp.py's bars: 5e-3 everywhere at 256×48; at 250×41 on
    the first 192 rows (below them the shards' bottom pad differs from the
    whole image's reflect pad)."""
    fwd = batch_forward(ranks.tiny_flagship())
    for k, (h, w) in enumerate(ranks.HALO_SHAPES):
        img = ranks.seeded_image(h, w, 4 + k)
        pad = np.pad(img, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="reflect")
        whole = fwd(pad[None])[0, :h, :w].numpy()
        got = runs[world]["halo_tiny"][(h, w)]
        assert got.shape == img.shape and np.isfinite(got).all()
        rows = h if h % (16 * world) == 0 else 192
        np.testing.assert_allclose(got[:rows], whole[:rows], atol=5e-3)


def test_halo_shard_single_rank_is_whole_image():
    img = ranks.seeded_image(64, 48, 0)
    fwd = batch_forward(ranks.tiny_flagship())
    one = spatial.halo_shard_forward(fwd, img, make_mesh("cpu"), halo=16)
    np.testing.assert_allclose(one, fwd(img[None])[0].numpy(), atol=1e-5)


def _flax_path_and_axis(model, name, dim):
    """The flax path of port parameter ``name`` and the flax axis its torch
    dim ``dim`` lands on (through the owning module's ``kernel_from_torch``)."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner)
    path = tuple(owner.split("."))
    p = model.get_parameter(name)
    if leaf == "weight" and hasattr(mod, "kernel_from_torch"):
        probe = torch.arange(p.shape[dim], dtype=torch.float32).reshape(
            [-1 if d == dim else 1 for d in range(p.ndim)]).expand(p.shape)
        k = mod.kernel_from_torch(probe)
        varies = [a for a in range(k.ndim) if k.shape[a] > 1
                  and not torch.equal(k.narrow(a, 0, 1).expand(k.shape), k)]
        assert len(varies) == 1, (name, varies)
        return path + ("kernel",), varies[0]
    flax = {v: k for k, v in getattr(mod, "FLAX_NAMES", {}).items()}
    return path + (flax.get(leaf, leaf),), dim


def test_placement_equals_jax_on_the_real_flagship_tree():
    model = AbstractMultiScaleGraphFilter(**flagship_config())
    shapes = jax.eval_shape(JaxFlagship(**flagship_config()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    jax_axes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        spec = tuple(jax_spec_for_param(path, leaf))
        jax_axes[tuple(str(getattr(k, "key", k)) for k in path)] = (
            spec.index(JAX_MODEL_AXIS) if JAX_MODEL_AXIS in spec else None)
    hits = {"expand": 0, "dw": 0, "proj": 0, "graph": 0}
    seen = set()
    for name, pl in param_shardings(model).items():
        path, axis = _flax_path_and_axis(model, name, pl.dim if pl else 0)
        seen.add(path)
        assert jax_axes[path] == (axis if pl else None), (name, pl, jax_axes[path])
        if pl is None:
            continue
        parts = name.split(".")
        kind = {"channels_linear_op": "expand", "channels_local_linear_op": "dw",
                "project_out": "proj"}.get(parts[-2], "graph")
        hits[kind] += 1
        assert pl.paired == (kind in ("expand", "dw")), name
    assert seen == set(jax_axes)
    assert hits == {"expand": 44, "dw": 44, "proj": 44, "graph": 112}, hits


@pytest.mark.parametrize("config,tp,ok", [
    ("tiny", 2, True), ("tiny", 3, False), ("tiny", 4, False),
    ("flagship", 8, True), ("flagship", 16, False)])
def test_check_tp_divisibility(config, tp, ok):
    kw = ranks.SP_TINY if config == "tiny" else flagship_config()
    model = AbstractMultiScaleGraphFilter(**kw)
    if ok:
        check_tp_divisibility(model, tp)
    else:
        with pytest.raises(ValueError, match=f"% tp {tp}"):
            check_tp_divisibility(model, tp)


@pytest.fixture(scope="module")
def reference():
    noisy, clean = ranks.global_batch()
    return {v: ranks.one_step(ranks.tiny_flagship(conv_variant=v), noisy, clean)
            for v in VARIANTS}


@pytest.mark.parametrize("world,tp,variant", [(2, 2, "plain")] + [(4, 2, v) for v in VARIANTS])
def test_tp_step_equals_one_process(tp_runs, reference, world, tp, variant):
    ref = reference[variant]
    for rank, res in enumerate(tp_runs[(world, tp)]):
        got = res[variant]
        assert abs(got["loss"] - ref["loss"]) <= 1e-4, (rank, got["loss"], ref["loss"])
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(), atol=5e-5,
                                       rtol=1e-3, err_msg=f"rank {rank} grad {n}")
        # one Adam step of lr 1e-3 from equal parameters moves each by
        # lr·g/(|g| + 1e-8): ±lr to 1e-6 where |g| > 1e-6, anything in
        # [-lr, lr] where g is near 0 and its gap swings the quotient
        for n, p in ref["params"].items():
            gap = (got["params"][n] - p).abs()
            if n not in ref["grads"]:  # a buffer (spectral_norm's kernel_u): unchanged
                assert float(gap.max()) == 0.0, (rank, n)
                continue
            steady = ref["grads"][n].abs() > 1e-6
            assert float(torch.where(steady, gap, 0.0).max()) <= 1e-6, (rank, n)
            assert float(gap.max()) <= 2e-3, (rank, n)
        for n, (m, v) in ref["moments"].items():
            gm, gv = got["moments"][n]
            np.testing.assert_allclose(gm.numpy(), m.numpy(), atol=5e-6, rtol=1e-3,
                                       err_msg=f"rank {rank} exp_avg {n}")
            np.testing.assert_allclose(gv.numpy(), v.numpy(), atol=1e-9, rtol=2e-3,
                                       err_msg=f"rank {rank} exp_avg_sq {n}")


def test_each_rank_holds_its_slices(tp_runs):
    """At tp = 2 a gated block's expand and depthwise hold H of 2H channels,
    its project H/2 of H inputs, a solver's α and multiM G/2 graphs; the
    embedding is whole."""
    full = dict(AbstractMultiScaleGraphFilter(**ranks.SP_TINY).named_parameters())
    local = tp_runs[(2, 2)][0]["plain"]["local_shapes"]
    blk = "encoder_scale_00_0.local_linear."
    assert local[blk + "channels_linear_op.weight"][0] * 2 == full[
        blk + "channels_linear_op.weight"].shape[0]
    assert local[blk + "channels_local_linear_op.weight"][0] * 2 == full[
        blk + "channels_local_linear_op.weight"].shape[0]
    assert local[blk + "project_out.weight"][1] * 2 == full[blk + "project_out.weight"].shape[1]
    assert local["localfilter_scale_03.local_filter.alphaCGD"][1] * 2 == full[
        "localfilter_scale_03.local_filter.alphaCGD"].shape[1]
    assert local["localfilter_scale_03.local_filter.GTVmodule00.multiM"][0] * 2 == full[
        "localfilter_scale_03.local_filter.GTVmodule00.multiM"].shape[0]
    emb = "patch_3x3_embeding.channels_local_linear_op01.weight"
    assert local[emb] == tuple(full[emb].shape)
