"""CTC loss on the alpha/beta recursions: wrappers of the CUDA kernels,
their plain versions, and the autograd Function that ties them together.

Counterpart of ``vistaocr_tpu/ops/ctc_pallas.py``. The kernels are
``csrc/ctc.cu`` (``_alpha_kernel`` and ``_beta_kernel``); its source note
says what it replaces, what bounds it and what its design does about
it. The assembly around them stays torch ops, as it sits outside the
kernels in JAX (``ctc_pallas.py:9-16``): ``_prepare`` (extended labels,
the one gather of ``lp_ext``, frame masks), ``_state_masks``,
``_loss_from_alphas`` (the terminal reduction to log P) and the fold of
d lp_ext back onto the classes (``ctc_pallas.py:263-318, 364-370``).
S = 2L+1 is not padded: the kernels take any S.

- ``ctc_alpha`` / ``ctc_beta``: on a CUDA tensor they launch the kernel
  or raise; on a CPU tensor they run ``ctc_alpha_ref`` / ``ctc_beta_ref``,
  loops over T vectorised over B and S with the kernels' arithmetic.
- ``CtcLoss`` / ``ctc_loss_kernel``: per-sample loss [B] with the
  alpha-beta gradient, d loss / d lp_ext = -exp(alpha + beta - lp -
  log P), chained through the incoming per-sample cotangent.
- ``ALPHA_LAUNCHES`` / ``BETA_LAUNCHES``: one per kernel launch.
"""

from __future__ import annotations

import threading

import torch

from .ctc import NEG_INF, logsumexp2, logsumexp3, shift

ALPHA_LAUNCHES = 0
BETA_LAUNCHES = 0
_count_lock = threading.Lock()


def ctc_alpha_ref(lp_ext, active, skip, svalid):
    """Plain alpha recursion: lp_ext [T, B, S], active [T, B], skip and
    svalid [B, S] (all float32, 1 = true) -> alphas [T, B, S]."""
    T, B, S = lp_ext.shape
    neg = torch.full((B, S), NEG_INF, device=lp_ext.device)
    alpha = neg.clone()
    alpha[:, 0] = 0.0
    skip, svalid = skip > 0, svalid > 0
    out = []
    for t in range(T):
        new = logsumexp3(alpha, shift(alpha, 1),
                         torch.where(skip, shift(alpha, 2), neg)) + lp_ext[t]
        new = torch.where(svalid, torch.maximum(new, neg), neg)
        alpha = torch.where(active[t][:, None] > 0, new, alpha)
        out.append(alpha)
    return torch.stack(out)


def ctc_beta_ref(lp_ext, active, islast, skip2, svalid, terminal, alphas,
                 logp):
    """Plain beta recursion emitting d(-log P)/d lp_ext [T, B, S]
    (``ctc_pallas.py:157-201``): lp_ext and alphas [T, B, S], active and
    islast [T, B], skip2, svalid and terminal [B, S], logp [B]."""
    T, B, S = lp_ext.shape
    neg = torch.full((B, S), NEG_INF, device=lp_ext.device)
    skip2, svalid = skip2 > 0, svalid > 0
    bt = neg
    lg = logp[:, None]
    out = [bt] * T
    for t in reversed(range(T)):
        lp = lp_ext[t]
        cont = logsumexp3(bt, shift(bt, -1),
                          torch.where(skip2, shift(bt, -2), neg))
        tail = torch.where(islast[t][:, None] > 0, terminal, cont)
        new = torch.where(svalid, torch.maximum(lp + tail, neg), neg)
        act = active[t][:, None] > 0
        bt = torch.where(act, new, bt)
        alpha = alphas[t]
        grad = -torch.exp(torch.clamp(alpha + bt - lp - lg, max=0.0))
        reach = (alpha > NEG_INF / 2) & (bt > NEG_INF / 2) & act
        out[t] = torch.where(reach, grad, torch.zeros_like(grad))
    return torch.stack(out)


def _check_launch(*tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the CTC kernels take CUDA tensors only")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the CTC kernels take contiguous float32 tensors")


def ctc_alpha(lp_ext, active, skip, svalid):
    """Alpha recursion: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    global ALPHA_LAUNCHES
    if not lp_ext.is_cuda:
        return ctc_alpha_ref(lp_ext, active, skip, svalid)
    from . import _build

    _check_launch(lp_ext, active, skip, svalid)
    T, B, S = lp_ext.shape
    alphas = torch.empty_like(lp_ext)
    err = _build.load().vo_ctc_alpha(
        T, B, S, lp_ext.data_ptr(), active.data_ptr(), skip.data_ptr(),
        svalid.data_ptr(), alphas.data_ptr(),
        torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, "vo_ctc_alpha")
    with _count_lock:
        ALPHA_LAUNCHES += 1
    return alphas


def ctc_beta(lp_ext, active, islast, skip2, svalid, terminal, alphas, logp):
    """Beta recursion and d lp_ext: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    global BETA_LAUNCHES
    if not lp_ext.is_cuda:
        return ctc_beta_ref(lp_ext, active, islast, skip2, svalid, terminal,
                            alphas, logp)
    from . import _build

    _check_launch(lp_ext, active, islast, skip2, svalid, terminal, alphas,
                  logp)
    T, B, S = lp_ext.shape
    dlp = torch.empty_like(lp_ext)
    err = _build.load().vo_ctc_beta(
        T, B, S, *(t.data_ptr() for t in (lp_ext, active, islast, skip2,
                                          svalid, terminal, alphas, logp,
                                          dlp)),
        torch.cuda.current_stream(lp_ext.device).cuda_stream)
    _build.check(err, "vo_ctc_beta")
    with _count_lock:
        BETA_LAUNCHES += 1
    return dlp


def _prepare(log_probs, input_lengths, labels, blank):
    """Extended labels and the kernels' inputs: lp_ext [T, B, S], skip
    [B, S], active and islast [T, B] (float32)."""
    B, T, K = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.to(torch.int64)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    skip = torch.zeros((B, S), dtype=torch.float32, device=dev)
    if L > 1:
        skip[:, 3::2] = (labels[:, 1:] != labels[:, :-1]).to(torch.float32)
    lp_ext = torch.gather(log_probs.to(torch.float32), 2,
                          ext[:, None, :].expand(B, T, S))
    lp_ext = lp_ext.transpose(0, 1).contiguous()  # [T, B, S]
    t_idx = torch.arange(T, device=dev)[:, None]
    il = input_lengths.to(dev)[None, :]
    active = (t_idx < il).to(torch.float32)
    islast = (t_idx == il - 1).to(torch.float32)
    return lp_ext, skip, active, islast


def _state_masks(label_lengths, S):
    """svalid [B, S] (1 on the 2*ll+1 real states) and terminal [B, S]
    (0 on the final blank and final symbol states, NEG_INF elsewhere)."""
    ll = label_lengths.to(torch.int64)[:, None]
    s_idx = torch.arange(S, device=ll.device)[None, :]
    n = 2 * ll + 1
    svalid = (s_idx < n).to(torch.float32)
    final = (s_idx == n - 1) | ((s_idx == n - 2) & (ll > 0))
    terminal = torch.where(final, torch.zeros_like(svalid),
                           torch.full_like(svalid, NEG_INF))
    return svalid, terminal


def _loss_from_alphas(alphas, input_lengths, label_lengths):
    """log P [B] from alpha at each sample's last frame, terminal states."""
    B = input_lengths.shape[0]
    last = torch.clamp(input_lengths.to(torch.int64) - 1, min=0)
    a_last = alphas[last, torch.arange(B, device=alphas.device)]  # [B, S]
    ll = label_lengths.to(torch.int64)
    idx_blank = (2 * ll)[:, None]
    a_blank = torch.gather(a_last, 1, idx_blank)[:, 0]
    a_sym = torch.gather(a_last, 1, torch.clamp(idx_blank - 1, min=0))[:, 0]
    a_sym = torch.where(ll > 0, a_sym, torch.full_like(a_sym, NEG_INF))
    return logsumexp2(a_blank, a_sym)


class CtcLoss(torch.autograd.Function):
    """``apply(log_probs, input_lengths, labels, label_lengths, blank,
    plain)`` -> per-sample loss [B] = -log P; the backward runs the beta
    recursion and folds d lp_ext onto the classes. ``plain`` runs the
    plain alpha/beta versions on any device."""

    @staticmethod
    def forward(ctx, log_probs, input_lengths, labels, label_lengths, blank,
                plain):
        dev = log_probs.device
        input_lengths = input_lengths.to(dev)
        label_lengths = label_lengths.to(dev)
        labels = labels.to(dev)
        lp_ext, skip, active, islast = _prepare(log_probs, input_lengths,
                                                labels, blank)
        svalid, terminal = _state_masks(label_lengths, lp_ext.shape[2])
        alpha = ctc_alpha_ref if plain else ctc_alpha
        alphas = alpha(lp_ext, active, skip, svalid)
        logp = _loss_from_alphas(alphas, input_lengths, label_lengths)
        ctx.save_for_backward(lp_ext, skip, active, islast, svalid, terminal,
                              alphas, logp, labels)
        ctx.meta = (blank, plain, log_probs.shape)
        return -logp

    @staticmethod
    def backward(ctx, g):
        (lp_ext, skip, active, islast, svalid, terminal, alphas, logp,
         labels) = ctx.saved_tensors
        blank, plain, (B, T, K) = ctx.meta
        L = labels.shape[1]
        # skip2[s] gates the beta transition s -> s+2: allowed iff skip[s+2]
        skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], 1)
        beta = ctc_beta_ref if plain else ctc_beta
        dlp_ext = beta(lp_ext, active, islast, skip2.contiguous(), svalid,
                       terminal, alphas, logp.contiguous())  # [T, B, S]
        dlp_ext = dlp_ext.transpose(0, 1) * g.to(torch.float32)[:, None, None]
        # Fold the extended states back onto the classes: even states are
        # the blank, odd state 2l+1 is label l.
        dlp = torch.zeros((B, T, K), dtype=torch.float32, device=g.device)
        dlp.scatter_add_(2, labels.to(torch.int64)[:, None, :].expand(B, T, L),
                         dlp_ext[:, :, 1:2 * L + 1:2])
        dlp[:, :, blank] += dlp_ext[:, :, 0:2 * L + 1:2].sum(dim=2)
        return dlp, None, None, None, None, None


def ctc_loss_kernel(log_probs, input_lengths, labels, label_lengths,
                    blank: int = 0, *, plain: bool = False) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood [B] through the alpha/beta
    recursions (the kernels on CUDA, the plain versions on the CPU or with
    ``plain``); a drop-in for ``ops.ctc.ctc_loss``."""
    return CtcLoss.apply(log_probs, input_lengths, labels, label_lengths,
                         blank, plain)
