"""The flagship's ``nsubnets > 1`` in the port against the JAX package: the
tiny flagship's forward at nsubnets (2, 2, 2, 2) and (2, 1, 2, 1) against
JAX's (f32, ``atol=5e-4, rtol=1e-3``); ``LocalNonLinearBlock`` at 2 and 4
subnets against JAX's; K3's and K4's plain versions with the subnet count
against the block modules (the operands the kernels take: dense
block-diagonal expand and project, exact); the K4 wgmma kernel's grouped
norm (partial sums per subnet and thread, two passes through shared
memory) transliterated against the plain norm; the wrappers'
refusals; ``params_to_torch``/``params_from_torch`` on JAX's grouped tree
with each ``conv_variant``; and the registry building JAX's tree."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irdu_tpu.models.blocks import LocalNonLinearBlock as JaxBlock
from irdu_tpu.models.flagship import AbstractMultiScaleGraphFilter as JaxFlagship
from irdu_tpu_torch.models import registry
from irdu_tpu_torch.models.blocks import LocalNonLinearBlock, block_diagonal
from irdu_tpu_torch.ops import block_stack as bs
from irdu_tpu_torch.ops import gated_block as gb
from irdu_tpu_torch.utils.weights import params_from_torch, params_to_torch

# tests/test_deploy.py's TINY flagship
TINY = dict(dims=(8, 12, 16, 24), hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4),
            num_blocks=(1, 1, 1, 1), num_blocks_out=1)
VARIANTS = ("plain", "spectral_norm", "non_expansive")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(model, x):
    params = jax.jit(model.init)(jax.random.key(0, impl="rbg"), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("nsubnets", [(2, 2, 2, 2), (2, 1, 2, 1)], ids=["2222", "2121"])
def test_tiny_flagship_matches_jax(nsubnets):
    """The port's forward (the blocks on K3/K4's plain versions, with dense
    block-diagonal operands and the per-subnet norm) against JAX's forward
    (its XLA path: JAX takes such blocks off its kernels) with JAX's
    parameters."""
    x = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    jm = JaxFlagship(**TINY, nsubnets=nsubnets)
    params = _jax_init(jm, x)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = registry.create_model("abstract_multiscale_graph_filter", **TINY,
                                  nsubnets=nsubnets).eval()
    params_to_torch(params, model)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    assert [m.groups for m in model.down_samples] == list(nsubnets[:3])
    assert [m.groups for m in model.up_samples] == list(nsubnets[1:])


@pytest.mark.parametrize("g", [2, 4])
def test_nonlinear_block_matches_jax(g):
    """``LocalNonLinearBlock`` at g subnets (C = 16, H = 24) against JAX's,
    NHWC there and CHW here, and its kernel operands through K4's plain
    version."""
    rng = np.random.RandomState(g)
    x = rng.randn(2, 6, 10, 16).astype(np.float32)
    jm = JaxBlock(16, 24, g)
    params = _jax_init(jm, x)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    block = LocalNonLinearBlock(16, 24, nsubnets=g)
    params_to_torch(params, block)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        out = block(xt)
        via_k4 = gb.fused_gated_block(xt, **block.gated_params(), nsubnets=g)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(via_k4, out, atol=2e-5, rtol=1e-4)


def _block(c, h, g, seed, variant="plain"):
    torch.manual_seed(seed)
    blk = LocalNonLinearBlock(c, h, variant, nsubnets=g)
    with torch.no_grad():
        blk.skip_weight.copy_(torch.tensor([0.7, 0.9]))
        blk.norm.weighted_transform.uniform_(0.5, 1.5)
    return blk


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("c,h,g", [(96, 192, 2), (48, 96, 4)], ids=["C96g2", "C48g4"])
def test_kernel_plain_versions_equal_the_blocks(c, h, g, variant):
    """K4's plain version (one block) and K3's (two blocks stacked) with the
    subnet count, on the operands ``gated_params`` hands the kernels, equal
    the modules' forward in f32."""
    blocks = [_block(c, h, g, s, variant) for s in (0, 1)]
    x = torch.from_numpy(np.random.RandomState(3).randn(1, c, 7, 9).astype(np.float32))
    with torch.no_grad():
        want1 = blocks[0](x)
        want2 = blocks[1](want1)
        p = [b.gated_params() for b in blocks]
        got1 = gb.gated_block_plain(x, **p[0], nsubnets=g)
        got2 = bs.block_stack_plain(x, *bs.pack_block_params(p, torch.float32), nsubnets=g)
        got_k3 = bs.fused_block_stack(x, *bs.pack_block_params(p, torch.float32), nsubnets=g)
    torch.testing.assert_close(got1, want1, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got2, want2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_k3, got2, atol=0, rtol=0)


@pytest.mark.parametrize("g", [2, 3, 4])
def test_block_diagonal_packing_is_exact(g):
    """A grouped 1×1 conv's dense block-diagonal matrix: ``conv2d`` with it
    equals the grouped conv bit for bit in f64, and every entry off the
    diagonal blocks is an exact zero."""
    rng = np.random.RandomState(g)
    o, i = 6 * g, 4 * g
    w = torch.from_numpy(rng.randn(o, i // g, 1, 1))
    dense = block_diagonal(w, g)
    assert dense.shape == (o, i)
    mask = torch.block_diag(*[torch.ones(o // g, i // g, dtype=torch.bool)] * g)
    assert not dense[~mask].any()
    torch.testing.assert_close(dense[mask].reshape(g, o // g, i // g),
                               w[:, :, 0, 0].reshape(g, o // g, i // g), atol=0, rtol=0)
    x = torch.from_numpy(rng.randn(1, i, 3, 5))
    grouped = torch.nn.functional.conv2d(x, w, groups=g)
    torch.testing.assert_close(torch.einsum("oi,bihw->bohw", dense, x), grouped,
                               atol=1e-12, rtol=1e-12)


def _k4_norm_scheme(x, scale, ns):
    """The wgmma kernel's grouped norm (``gated_block.cu``), one pixel a row of
    ``x`` (P, C): kTpp threads a pixel (4 at C = 384, else 1), thread
    ``part`` holding channels [part·C/kTpp, (part+1)·C/kTpp); pass 1 writes
    each thread's sum of every subnet's channels among its own to
    red[sub][part][pixel] (zero where it holds none), pass 2 its squared
    deviations from the subnet's mean to red2; part 0 writes each subnet's
    1 / sqrt(var + eps) to red[sub][0][pixel], and each 8-channel group is
    written with the inv its subnet index (c + 0.5) · (1 / cs), truncated,
    picks, times the scale. Returns y0 (P, C)."""
    p_n, c = x.shape
    ktpp = 4 if c > 192 else 1
    kcpt, cs = c // ktpp, c // ns
    red = np.zeros((ns, ktpp, p_n), np.float32)
    red2 = np.zeros_like(red)
    for out, pass_ in ((red, 0), (red2, 1)):
        for part in range(ktpp):
            cb = part * kcpt
            for sub in range(ns):
                lo, hi = max(sub * cs, cb) - cb, min(sub * cs + cs, cb + kcpt) - cb
                mean = red[sub].sum(axis=0) / cs if pass_ else 0.0
                total = np.zeros(p_n, np.float32)
                for ch in range(lo, hi):
                    d = x[:, cb + ch] - mean
                    total = total + (d * d if pass_ else d)
                out[sub, part] = total
    inv = 1.0 / np.sqrt(red2.sum(axis=1) / (cs - 1) + 1e-5)  # (ns, P)
    rcp = np.float32(1.0) / np.float32(cs)
    y0 = np.empty_like(x)
    for ch in range(0, c, 8):
        sub = int(np.float32(ch + 0.5) * rcp)
        y0[:, ch:ch + 8] = x[:, ch:ch + 8] * inv[sub][:, None] * scale[ch:ch + 8]
    return y0


@pytest.mark.parametrize("c,ns", [(96, 2), (96, 4), (192, 3), (384, 2), (384, 8)])
def test_k4_grouped_norm_scheme(c, ns):
    """The kernel's grouped norm, transliterated, against ``subnet_norm``
    times the scale; and the shapes it takes (``gated_subnets_ok``: runs of
    a multiple of 8 channels, the partial sums within Y1)."""
    assert gb.gated_subnets_ok(c, ns)
    rng = np.random.RandomState(c + ns)
    x = (rng.randn(37, c) * rng.rand(37, 1) * 3).astype(np.float32)
    scale = (0.5 + rng.rand(c)).astype(np.float32)
    want = gb.subnet_norm(torch.from_numpy(x.T.copy())[None, :, :, None], ns)[0, :, :, 0].T
    np.testing.assert_allclose(_k4_norm_scheme(x, scale, ns), want.numpy() * scale,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c,ns,ok", [(96, 12, True), (96, 24, False), (384, 16, False),
                                     (192, 16, False), (128, 16, True)])
def test_k4_subnets_it_takes(c, ns, ok):
    """Runs of a multiple of 8 channels, at most 8 subnets at C = 384 (the
    partial sums of both passes beside the scale in Y1's 64 × 72 floats)."""
    assert gb.gated_subnets_ok(c, ns) == ok


def test_wrappers_refuse_subnets_that_do_not_split_c():
    x = torch.zeros(1, 12, 4, 4)
    p = dict(scale=torch.ones(12), w1=torch.zeros(12, 8), dwk=torch.zeros(3, 3, 8),
             w2=torch.zeros(4, 12), skip=torch.ones(2))
    with pytest.raises(ValueError, match="nsubnets"):
        gb.fused_gated_block(x, **p, nsubnets=5)
    with pytest.raises(ValueError, match="nsubnets"):
        bs.fused_block_stack(x, *bs.pack_block_params([p], torch.float32), nsubnets=12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_params_round_trip_on_jax_grouped_tree(variant):
    """JAX's tree of the tiny flagship at nsubnets (2, 2, 2, 2), every leaf
    a distinct seeded value, onto the port and back, leaf for leaf and bit
    for bit; the spectral vectors too. The grouped down/up samples of the
    non-expansive variant have no ``scaling_factor``, in JAX as here."""
    jm = JaxFlagship(**TINY, nsubnets=(2, 2, 2, 2), conv_variant=variant)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    rng = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    model = registry.create_model("abstract_multiscale_graph_filter", **TINY,
                                  nsubnets=(2, 2, 2, 2), conv_variant=variant)
    params_to_torch(tree, model)
    back = params_from_torch(model)
    assert sorted(back) == sorted(tree)
    for coll in tree:
        flat = dict(jax.tree_util.tree_flatten_with_path(tree[coll])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[coll])[0])
        assert set(flat) == set(got), coll
        for path, leaf in flat.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    down = tree["params"]["down_sample_00_01"]
    assert ("scaling_factor" in down) == False  # noqa: E712
    if variant == "non_expansive":
        assert "scaling_factor" in tree["params"]["combine_channels_00"]


@pytest.mark.parametrize("nsubnets", [(2, 2, 2, 2), (4, 2, 2, 1)], ids=["2222", "4221"])
def test_registry_builds_jax_tree(nsubnets):
    """``create_model`` with ``nsubnets`` (the tiny widths; the default
    widths at (2, 1, 1, 1) are ``test_torch_registry.py``'s) takes JAX's
    tree (zero-filled) leaf for leaf: every parameter set, each of JAX's
    shapes, the parameter counts equal."""
    jm = JaxFlagship(**TINY, nsubnets=nsubnets)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = registry.create_model("abstract_multiscale_graph_filter", **TINY,
                                 nsubnets=nsubnets)
    params_to_torch(zeros, port)
    assert not any(p.detach().any() for p in port.parameters())
    assert (sum(p.numel() for p in port.parameters())
            == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)))


def test_grouped_flagship_refuses_widths_its_subnets_do_not_split():
    """A subnet count that does not divide a width is refused, naming the
    field (JAX's reshape of the grouped kernel fails there too)."""
    with pytest.raises(ValueError, match="nsubnets"):
        registry.create_model("abstract_multiscale_graph_filter", **TINY, nsubnets=(3, 1, 1, 1))
    with pytest.raises(Exception):
        jax.eval_shape(lambda: JaxFlagship(**TINY, nsubnets=(3, 1, 1, 1)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
