"""The port's CTC (ops/ctc.py, ops/ctc_cuda.py) against the JAX package:
the lax.scan oracle ``ops.ctc.ctc_loss`` (values and ``jax.grad``), the
Pallas alpha/beta kernels in interpret mode (``ctc_loss_pallas``,
``_run_alpha_local``, ``_run_beta_local``), and ``mean_ctc_loss`` with
weights and ``label_average``; ``torch.nn.functional.ctc_loss`` as a
second oracle on feasible samples. Same numpy inputs; values and
gradients within 2e-5 (the JAX kernel's own bound,
tests/test_ctc_pallas.py:47). On the CPU the port's kernel wrappers run
their plain versions; the CUDA kernels' own tests are in
tests/test_torch_port_cuda.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vistaocr_tpu.ops import ctc as jax_ctc
from vistaocr_tpu.ops import ctc_pallas as jax_ctc_pallas
from vistaocr_tpu_torch.ops import ctc as port_ctc
from vistaocr_tpu_torch.ops import ctc_cuda

torch.set_num_threads(2)
TOL = 2e-5


def _case(seed, B=6, T=18, K=9, L=5, infeasible=False):
    """log-probs [B,T,K], input lengths, labels with a repeat, label
    lengths with an empty label (and optionally an infeasible sample)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, K)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.integers(1, K, (B, L)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    ll = rng.integers(1, L + 1, B).astype(np.int32)
    ll[0], ll[1] = L, 0
    il = rng.integers(2 * L + 1, T + 1, B).astype(np.int32)
    il[0] = T
    if infeasible:
        ll[2], il[2] = L, L - 2
    return lp, il, labels, ll


def _jax_loss_and_grad(lp, il, labels, ll, fn):
    args = (jnp.asarray(il), jnp.asarray(labels), jnp.asarray(ll))
    loss = fn(jnp.asarray(lp), *args)
    grad = jax.grad(lambda x: fn(x, *args).sum())(jnp.asarray(lp))
    return np.asarray(loss), np.asarray(grad)


def _port_loss_and_grad(lp, il, labels, ll, fn):
    x = torch.tensor(lp, requires_grad=True)
    loss = fn(x, torch.from_numpy(il), torch.from_numpy(labels),
              torch.from_numpy(ll))
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("port_impl", ["scan", "function"])
def test_matches_jax_scan_oracle(seed, port_impl):
    lp, il, labels, ll = _case(seed)
    ref, ref_g = _jax_loss_and_grad(lp, il, labels, ll, jax_ctc.ctc_loss)
    fn = (port_ctc.ctc_loss if port_impl == "scan"
          else ctc_cuda.ctc_loss_kernel)
    ours, ours_g = _port_loss_and_grad(lp, il, labels, ll, fn)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours_g, ref_g, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_function_matches_pallas_interpret(seed):
    lp, il, labels, ll = _case(seed, B=5, T=16, K=7, L=4)

    def pallas(x, il_, lab, ll_):
        return jax_ctc_pallas.ctc_loss_pallas(x, il_, lab, ll_, 0, True)

    ref, ref_g = _jax_loss_and_grad(lp, il, labels, ll, pallas)
    ours, ours_g = _port_loss_and_grad(
        lp, il, labels, ll,
        lambda *a: ctc_cuda.ctc_loss_kernel(*a, plain=True))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours_g, ref_g, rtol=TOL, atol=TOL)


def _refs_match_pallas_interpret_kernels(lp, il, labels, ll):
    """The plain recursions against the Pallas kernels run one by one, on
    the same prepared inputs, compared on valid states."""
    lp_ext_j, skip_j, active_j, islast_j, _, S = jax_ctc_pallas._prepare(
        jnp.asarray(lp), jnp.asarray(il), jnp.asarray(labels), 0)
    svalid_j, terminal_j = jax_ctc_pallas._state_masks(jnp.asarray(ll), S)
    alphas_j = jax_ctc_pallas._run_alpha_local(
        lp_ext_j, active_j, skip_j, svalid_j, interpret=True)
    logp_j = jax_ctc_pallas._loss_from_alphas(alphas_j, jnp.asarray(il),
                                              jnp.asarray(ll))
    skip2_j = jax_ctc_pallas._shift_left_lanes_host(skip_j, 2)
    dlp_j = jax_ctc_pallas._run_beta_local(
        lp_ext_j, active_j, islast_j, skip2_j, svalid_j, terminal_j,
        alphas_j, logp_j[None, :], interpret=True)

    lp_ext, skip, active, islast = ctc_cuda._prepare(
        torch.from_numpy(lp), torch.from_numpy(il), torch.from_numpy(labels),
        0)
    S_port = lp_ext.shape[2]
    assert S_port == 2 * labels.shape[1] + 1 and S >= S_port
    svalid, terminal = ctc_cuda._state_masks(torch.from_numpy(ll), S_port)
    alphas = ctc_cuda.ctc_alpha_ref(lp_ext, active, skip, svalid)
    logp = ctc_cuda._loss_from_alphas(alphas, torch.from_numpy(il),
                                      torch.from_numpy(ll))
    skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], 1)
    dlp = ctc_cuda.ctc_beta_ref(lp_ext, active, islast, skip2, svalid,
                                terminal, alphas, logp)
    assert alphas.shape == dlp.shape == lp_ext.shape

    np.testing.assert_allclose(np.asarray(lp_ext_j)[..., :S_port],
                               lp_ext.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), atol=TOL,
                               rtol=TOL)
    valid = svalid.numpy()[None].astype(bool).repeat(lp_ext.shape[0], 0)
    np.testing.assert_allclose(alphas.numpy()[valid],
                               np.asarray(alphas_j)[..., :S_port][valid],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dlp.numpy(), np.asarray(dlp_j)[..., :S_port],
                               atol=TOL, rtol=TOL)


def test_alpha_beta_refs_match_pallas_interpret_kernels():
    _refs_match_pallas_interpret_kernels(*_case(4, B=4, T=12, K=6, L=3))


def test_refs_keep_one_state_rows():
    """S = 1 (a batch of empty labels): the plain recursions return
    [T, B, 1], as the Pallas kernels and the CUDA kernels do (the
    shifted neighbours s-2 and s+2 lie wholly outside the row), and match
    the Pallas kernels in interpret mode (the JAX scan oracle cannot take
    S = 1: its right shift by 2 widens the row and breaks its scan)."""
    rng = np.random.default_rng(9)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.normal(0, 2, (3, 7, 5)).astype(np.float32)), axis=-1))
    il = np.array([7, 1, 4], np.int32)
    labels = np.zeros((3, 0), np.int32)
    ll = np.zeros(3, np.int32)
    _refs_match_pallas_interpret_kernels(lp, il, labels, ll)
    ref, ref_g = _jax_loss_and_grad(
        lp, il, labels, ll,
        lambda *a: jax_ctc_pallas.ctc_loss_pallas(*a, 0, True))
    for fn in (port_ctc.ctc_loss, ctc_cuda.ctc_loss_kernel):
        ours, ours_g = _port_loss_and_grad(lp, il, labels, ll, fn)
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ours_g, ref_g, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("port_impl", ["scan", "function"])
def test_repeats_empty_labels_and_infeasible_sample(port_impl):
    lp, il, labels, ll = _case(5, infeasible=True)
    fn = (port_ctc.ctc_loss if port_impl == "scan"
          else ctc_cuda.ctc_loss_kernel)
    ours, ours_g = _port_loss_and_grad(lp, il, labels, ll, fn)
    ref, ref_g = _jax_loss_and_grad(lp, il, labels, ll, jax_ctc.ctc_loss)
    assert np.isfinite(ours).all() and np.isfinite(ours_g).all()
    assert ours[2] > 1e29  # the infeasible sample: finite ~1e30
    assert np.abs(ours_g[2]).max() == 0.0
    assert 0 < ours[1] < 1e3  # the empty label: all-blank path
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours_g, ref_g, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("label_average", [False, True])
@pytest.mark.parametrize("impl", ["scan", "pallas_interpret", "auto"])
def test_mean_ctc_loss_with_weights(label_average, impl):
    lp, il, labels, ll = _case(6)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32)

    def jax_mean(x):
        return jax_ctc.mean_ctc_loss(
            x, jnp.asarray(il), jnp.asarray(labels), jnp.asarray(ll),
            sample_weights=jnp.asarray(w), label_average=label_average,
            impl="scan")

    ref, ref_g = jax.value_and_grad(jax_mean)(jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    ours = port_ctc.mean_ctc_loss(
        x, torch.from_numpy(il), torch.from_numpy(labels),
        torch.from_numpy(ll), sample_weights=torch.from_numpy(w),
        label_average=label_average, impl=impl)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=TOL,
                               atol=TOL)


def test_torch_ctc_loss_as_second_oracle():
    """Feasible samples only: torch's own CTC (which returns inf on
    infeasible ones) agrees with the port's per-sample losses, and with
    its gradients taken through a log-softmax (torch's CTC backward
    assumes log-softmax inputs)."""
    lp, il, labels, ll = _case(7)
    lens = [torch.from_numpy(a).long() for a in (labels, il, ll)]
    grads, losses = [], []
    for ours in (True, False):
        x = torch.tensor(lp, requires_grad=True)
        logp = torch.log_softmax(x, dim=-1)
        if ours:
            loss = ctc_cuda.ctc_loss_kernel(logp, lens[1], lens[0], lens[2])
        else:
            loss = torch.nn.functional.ctc_loss(
                logp.transpose(0, 1), lens[0], lens[1], lens[2], blank=0,
                reduction="none")
        loss.sum().backward()
        losses.append(loss.detach().numpy())
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-4)


def test_impl_switch():
    lp, il, labels, ll = _case(8, B=2, T=6, K=4, L=2)
    args = (torch.from_numpy(lp), torch.from_numpy(il),
            torch.from_numpy(labels), torch.from_numpy(ll))
    before = (ctc_cuda.ALPHA_LAUNCHES, ctc_cuda.BETA_LAUNCHES)
    x = args[0].clone().requires_grad_(True)
    port_ctc.mean_ctc_loss(x, *args[1:], impl="auto").backward()
    assert (ctc_cuda.ALPHA_LAUNCHES, ctc_cuda.BETA_LAUNCHES) == before
    with pytest.raises(RuntimeError):
        port_ctc.mean_ctc_loss(*args, impl="pallas")
    with pytest.raises(ValueError):
        port_ctc.mean_ctc_loss(*args, impl="warpctc")
    with pytest.raises(ValueError):  # the launch refuses CPU tensors
        ctc_cuda._check_launch(args[0])
