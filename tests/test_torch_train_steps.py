"""Training steps and the switches they rely on, on the CPU: the kernel
wrappers' autograd guard (reached through the meta device, which takes the
launch route), ``set_kernels`` reaching the pixel solver, ``remat`` on
against off, the loss's latent draws, the lr index of an update, and a
float64 finite-difference check of the pixel loss's gradient.

The pixel family's JAX gradient reference, on a narrow pixel model, is
``test_torch_train_pixel_grad.py``; here the plain route's gradient is also
held to central differences in float64.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from irdu_tpu_torch.kernels.build import refuse_grad
from irdu_tpu_torch.models.flagship import AbstractMultiScaleGraphFilter
from irdu_tpu_torch.models.pixel import MultiScaleSequenceDenoiser
from irdu_tpu_torch.models.registry import set_kernels, set_remat
from irdu_tpu_torch.ops.block_stack import fused_block_stack
from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw, gg_matvec_chw, gtv_rethresh_chw
from irdu_tpu_torch.ops.gated_block import fused_gated_block
from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc
from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw
from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
from irdu_tpu_torch.ops.system_matvec import fused_system_matvec
from irdu_tpu_torch.train.steps import (create_train_state, draw_latent_noise, flagship_loss,
                                        make_train_step, teacher_forward)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs tiny shapes: one thread runs them about as fast,
    and the test workers' threads do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WRAPPERS = (fused_block_stack, fused_gated_block, gg_unroll_chw, edge_weights_chw,
            gg_fused_step_chw, gg_matvec_chw, gtv_rethresh_chw, gg_pixel_unroll_chw,
            pixel_segment_nhwc, fused_system_matvec)
TINY = dict(n_channels_in=3, n_channels_out=3, dims=(8, 12, 16, 24),
            hidden_dims=(16, 24, 32, 48), ngraphs=(2, 2, 4, 4), num_blocks=(1, 1, 1, 1),
            num_blocks_out=1)
PIXEL = dict(n_graphs=2, n_node_fts=3, n_cnn_fts=8, feature_num_blocks=(1, 1, 1, 1),
             feature_num_refinement=1)


def _meta_call(wrapper, grad_at):
    """``wrapper`` with a meta tensor for each positional argument (the one
    at ``grad_at`` requiring grad) and dummies for its required keywords:
    the wrapper's launch route, as a CUDA tensor takes it."""
    sig = inspect.signature(wrapper)
    pos = [p for p in sig.parameters.values() if p.kind is p.POSITIONAL_OR_KEYWORD]
    args = [torch.zeros(2, 2, device="meta", requires_grad=(i == grad_at))
            for i in range(len(pos))]
    kw = {p.name: ("cg" if p.name == "mode" else 2) for p in sig.parameters.values()
          if p.kind is p.KEYWORD_ONLY and p.default is p.empty}
    return wrapper(*args, **kw)


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_kernel_wrapper_refuses_grad(wrapper):
    """Off the CPU, under grad, an argument that requires grad (the first or
    the last) raises the guard's RuntimeError naming the kernel and
    ``set_kernels(model, False)``, before any launch; the launch count stays."""
    n_pos = sum(p.kind is p.POSITIONAL_OR_KEYWORD
                for p in inspect.signature(wrapper).parameters.values())
    before = wrapper.launches
    for grad_at in (0, n_pos - 1):
        with pytest.raises(RuntimeError, match=f"{wrapper.__name__}: .*set_kernels"):
            _meta_call(wrapper, grad_at)
    assert wrapper.launches == before


def test_guard_lets_inference_and_cpu_through():
    """No error under inference_mode or no_grad, for a CPU first tensor, or
    with nothing requiring grad; a CPU tensor that requires grad takes the
    differentiable plain version."""
    meta = torch.zeros(2, device="meta", requires_grad=True)
    with torch.inference_mode():
        refuse_grad("k", meta)
    with torch.no_grad():
        refuse_grad("k", meta)
    refuse_grad("k", torch.zeros(2, requires_grad=True), meta)
    refuse_grad("k", torch.zeros(2, device="meta"), None, 3)
    feats = torch.rand(1, 4, 6, 6, requires_grad=True)
    w = edge_weights_chw(feats, torch.ones(2, 2), n_graphs=2)
    w[:, :, 0].sum().backward()
    assert feats.grad is not None and feats.grad.abs().max() > 0


def test_set_kernels_reaches_the_pixel_solver():
    """The pixel solver's ``use_kernels`` switch: off, its route is plain
    whatever the flags say; on, the flags' route again."""
    model = MultiScaleSequenceDenoiser(**PIXEL, use_pallas_solver=True, use_nhwc_solver=True)
    mix = model.mixtureGLR_block03
    assert mix.route() == "nhwc"
    set_kernels(model, False)
    assert mix.route() == "plain" and mix.use_nhwc_unroll
    set_kernels(model, True)
    assert mix.route() == "nhwc"
    mix.use_nhwc_unroll = False
    assert mix.route() == "chw"


def _grads(model, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("family", ["flagship", "pixel"])
def test_remat_on_and_off_agree(family):
    """``remat`` recomputes in the backward pass: the same loss, the same
    gradients (on the CPU the recomputation is the same arithmetic), and the
    parameter names unchanged; ``set_remat`` reaches every switch."""
    torch.manual_seed(0)
    rs = np.random.RandomState(1)
    if family == "flagship":
        model = AbstractMultiScaleGraphFilter(**TINY, remat=True)
        x, y = (torch.from_numpy(rs.rand(2, 32, 32, 3).astype(np.float32)) for _ in range(2))
        noise = draw_latent_noise(model.encode(y), torch.Generator().manual_seed(3))
        loss_fn = lambda m: flagship_loss(m, x, y, latent_noise=noise)[0]  # noqa: E731
        switches = [model]
    else:
        model = MultiScaleSequenceDenoiser(**PIXEL, remat=True)
        x, y = (torch.from_numpy(rs.rand(2, 16, 16, 3).astype(np.float32)) for _ in range(2))
        loss_fn = lambda m: flagship_loss(m, x, y, use_aux_losses=False)[0]  # noqa: E731
        mix = model.mixtureGLR_block03
        switches = [mix, mix.patchs_features_extraction]
    names = [n for n, _ in model.named_parameters()]
    assert all(m.remat for m in switches)
    on = _grads(model, loss_fn)
    set_remat(model, False)
    assert not any(m.remat for m in switches)
    off = _grads(model, loss_fn)
    assert [n for n, _ in model.named_parameters()] == names
    assert on[0] == off[0]
    for n in names:
        torch.testing.assert_close(on[1][n], off[1][n], rtol=1e-6, atol=1e-9)


def test_latent_noise_draws_and_passing_agree():
    """The loss with the generator's draws equals the loss with those draws
    passed in; another seed gives another loss; no aux terms, no draw."""
    torch.manual_seed(0)
    model = AbstractMultiScaleGraphFilter(**TINY)
    rs = np.random.RandomState(2)
    x, y = (torch.from_numpy(rs.rand(1, 32, 32, 3).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        drawn = flagship_loss(model, x, y, generator=torch.Generator().manual_seed(5))[0]
        noise = draw_latent_noise(model.encode(y), torch.Generator().manual_seed(5))
        passed = flagship_loss(model, x, y, latent_noise=noise)[0]
        other = flagship_loss(model, x, y, generator=torch.Generator().manual_seed(6))[0]
        gen = torch.Generator().manual_seed(7)
        state = gen.get_state()
        l1 = flagship_loss(model, x, y, generator=gen, use_aux_losses=False)[0]
    assert [c.shape for c in noise] == [(1, 8, 32, 32), (1, 12, 16, 16), (1, 16, 8, 8),
                                        (1, 24, 4, 4)]
    assert float(drawn) == float(passed) != float(other)
    assert torch.equal(gen.get_state(), state)
    assert float(l1) == pytest.approx(float((model(x) - y).abs().mean()), rel=1e-6)


def test_update_k_takes_the_lr_of_k():
    """Update k runs at ``schedule(k)``, counted from 0 (optax's count): with
    a zero lr at even k the parameters move only on odd updates; the metrics
    are the clipped-PSNR of the batch."""
    torch.manual_seed(0)
    model = AbstractMultiScaleGraphFilter(**TINY)
    state = create_train_state(model, lambda k: 0.0 if k % 2 == 0 else 1e-3)
    step = make_train_step(use_aux_losses=False)
    rs = np.random.RandomState(3)
    x, y = (torch.from_numpy(rs.rand(1, 32, 32, 3).astype(np.float32)) for _ in range(2))
    moved = []
    for k in range(3):
        before = [p.detach().clone() for p in model.parameters()]
        state, m = step(state, x, y)
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, model.parameters())))
        assert state.step == k + 1
        assert state.optimizer.param_groups[0]["lr"] == state.schedule(k)
    assert moved == [False, True, False]
    with torch.no_grad():
        mse = float(((y.clamp(0, 1) - model(x).clamp(0, 1)) ** 2).mean())
    assert set(m) == {"loss", "mse", "psnr"} and float(m["psnr"]) > 0 and mse > 0


def test_teacher_forward_is_a_constant_in_the_students_dtype():
    """The teacher runs in its own dtype (bf16 here) under inference mode; its
    output comes back in the input's dtype, out of inference mode, so that
    autograd takes it as a constant."""
    torch.manual_seed(0)
    teacher = AbstractMultiScaleGraphFilter(**TINY).to(torch.bfloat16).requires_grad_(False)
    x = torch.rand(1, 32, 32, 3)
    out = teacher_forward(teacher, x)
    assert out.dtype == torch.float32 and not out.is_inference() and not out.requires_grad
    with torch.inference_mode():
        want = teacher(x.to(torch.bfloat16)).float()
    assert torch.equal(out, want)


def test_pixel_loss_gradient_matches_finite_differences():
    """The pixel model's L1 loss (its configs train without aux terms) in
    float64 through the plain route: autograd against central differences
    (h = 1e-6) on a weight of the feature U-Net, of the DC estimator and of
    the mixture combination, the solver's CG step, μ, ρ, log γ, a metric
    entry, a stencil coefficient and the global skip."""
    torch.manual_seed(0)
    model = MultiScaleSequenceDenoiser(**PIXEL).double()
    set_kernels(model, False)
    rs = np.random.RandomState(4)
    clean = torch.from_numpy(rs.rand(1, 12, 16, 3))
    noisy = clean + 0.1 * torch.from_numpy(rs.randn(1, 12, 16, 3))

    def loss():
        return flagship_loss(model, noisy, clean, use_aux_losses=False)[0]

    feats = "mixtureGLR_block03.patchs_features_extraction"
    picks = [(f"{feats}.patch_embed.proj.weight", (0, 0, 1, 1)),
             ("mixtureGLR_block03.dc_estimator.project_in.weight", (1, 2, 0, 0)),
             ("mixtureGLR_block03.combination_weight.weight", (1, 3, 0, 0)),
             ("mixtureGLR_block03.alphaCGD", (1, 0)), ("mixtureGLR_block03.muys00", (1,)),
             ("mixtureGLR_block03.ro00", (0,)), ("mixtureGLR_block03.gamma00", (1,)),
             ("mixtureGLR_block03.GTVmodule00.multiM", (0, 2)),
             ("mixtureGLR_block03.GLRmodule00.stats_p03", (0,)),
             ("skip_connect_weight03", (1,))]
    params = dict(model.named_parameters())
    loss().backward()
    for name, idx in picks:
        p = params[name]
        analytic = float(p.grad[idx])
        with torch.no_grad():
            p[idx] += 1e-6
            up = float(loss())
            p[idx] -= 2e-6
            down = float(loss())
            p[idx] += 1e-6
        numeric = (up - down) / 2e-6
        assert analytic == pytest.approx(numeric, rel=1e-4, abs=1e-9), name
