"""CTC loss: the plain log-space recursion (the ``"scan"`` oracle) and the
batch-reduced training loss.

Counterpart of ``vistaocr_tpu/ops/ctc.py:29-157``. ``ctc_loss`` is a
Python loop over T, vectorised over B and the S = 2L+1 extended-label
states, differentiated by autograd. It keeps the reference's conventions:
``NEG_INF = -1e30`` stands in for -inf (never ``inf``), so an infeasible
sample (label longer than its frames) gets a finite ~1e30 loss with
finite gradients, and frames past ``input_length`` pass the alpha row
through unchanged. ``mean_ctc_loss`` picks the implementation by
``impl``, with the LSTM's rule (``models/blstm.py``):

- ``"auto"``: the CUDA kernels (``ops/ctc_cuda.py``) for CUDA tensors,
  their plain versions for CPU tensors;
- ``"scan"``: this module's autograd oracle on any device;
- ``"pallas"``: the kernels; raises off CUDA;
- ``"pallas_interpret"``: the plain alpha/beta versions behind the same
  ``torch.autograd.Function`` as the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum

NEG_INF = -1.0e30
IMPLS = ("auto", "scan", "pallas", "pallas_interpret")


def logsumexp3(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """NaN-safe three-way log-sum-exp: NEG_INF where every input is
    unreachable (``m <= NEG_INF / 2``), with the "double where" that keeps
    autograd away from log(0)."""
    m = torch.maximum(torch.maximum(a, b), c)
    valid = m > NEG_INF / 2
    m_safe = torch.where(valid, m, torch.zeros_like(m))
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.where(valid, s, torch.ones_like(s)))
    return torch.where(valid, out, torch.full_like(out, NEG_INF))


def logsumexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NaN-safe two-way log-sum-exp (the terminal reduction)."""
    m = torch.maximum(a, b)
    valid = m > NEG_INF / 2
    m_safe = torch.where(valid, m, torch.zeros_like(m))
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    tot = m_safe + torch.log(torch.where(valid, s, torch.ones_like(s)))
    return torch.where(valid, tot, torch.full_like(tot, NEG_INF))


def shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x[..., s - k]`` along the last axis (k > 0 shifts right, k < 0
    left), NEG_INF where that index falls outside (everywhere when |k| is
    not below the axis's length, as for S = 1)."""
    if abs(k) >= x.shape[-1]:
        return torch.full_like(x, NEG_INF)
    if k > 0:
        return F.pad(x[..., :-k], (k, 0), value=NEG_INF)
    return F.pad(x[..., -k:], (0, -k), value=NEG_INF)


def ctc_loss(
    log_probs: torch.Tensor,  # [B, T, K] log-softmax outputs
    input_lengths: torch.Tensor,  # [B] valid frame counts
    labels: torch.Tensor,  # [B, L] 0-padded, no blanks
    label_lengths: torch.Tensor,  # [B]
    blank: int = 0,
) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood, shape [B] (f32)."""
    B, T, K = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.to(torch.int64)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    if L > 1:
        skip[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    neg = torch.full((B, S), NEG_INF, device=dev)

    alpha = neg.clone()
    alpha[:, 0] = 0.0
    lp = log_probs.to(torch.float32)
    lp_ext = torch.gather(lp, 2, ext[:, None, :].expand(B, T, S))
    active = (torch.arange(T, device=dev)[:, None]
              < input_lengths.to(dev)[None, :])  # [T, B]
    for t in range(T):
        adv = shift(alpha, 1)
        skp = torch.where(skip, shift(alpha, 2), neg)
        new = logsumexp3(alpha, adv, skp) + lp_ext[:, t]
        new = torch.maximum(new, neg)
        alpha = torch.where(active[t][:, None], new, alpha)

    ll = label_lengths.to(torch.int64).to(dev)
    idx_last = (2 * ll)[:, None]
    a_blank = torch.gather(alpha, 1, idx_last)[:, 0]
    a_sym = torch.gather(alpha, 1, torch.clamp(idx_last - 1, min=0))[:, 0]
    a_sym = torch.where(ll > 0, a_sym, torch.full_like(a_sym, NEG_INF))
    return -logsumexp2(a_blank, a_sym)


def mean_ctc_loss(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    blank: int = 0,
    sample_weights: Optional[torch.Tensor] = None,
    label_average: bool = False,
    impl: str = "auto",
    group=None,
) -> torch.Tensor:
    """Batch-reduced CTC loss for training (``ops/ctc.py:122-157``):
    per-sample losses, optionally divided by their label lengths, averaged
    with ``sample_weights`` (which mask padding duplicates). Under data
    parallelism (``group``: the ranks, each with its rows of the global
    batch) the denominator is the global weight sum, summed over the group
    without a gradient, so this rank's share of the global mean comes
    back and the SUM of the ranks' gradients is the single-device one.
    The ranks' weight sums differ (padding rows weigh 0), so averaging
    each rank's own mean would be wrong."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ctc_impl {impl!r}; one of {IMPLS}")
    if impl == "scan":
        per = ctc_loss(log_probs, input_lengths, labels, label_lengths,
                       blank=blank)
    else:
        from .ctc_cuda import ctc_loss_kernel

        if impl == "pallas" and not log_probs.is_cuda:
            raise RuntimeError(
                "ctc_impl='pallas' runs the CUDA kernels and needs CUDA "
                f"tensors, got {log_probs.device}")
        per = ctc_loss_kernel(log_probs, input_lengths, labels,
                              label_lengths, blank,
                              plain=impl == "pallas_interpret")
    if label_average:
        per = per / torch.clamp(label_lengths.to(torch.float32), min=1.0)
    if group is None:
        if sample_weights is None:
            return per.mean()
        w = sample_weights.to(torch.float32)
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
    w = (torch.ones_like(per) if sample_weights is None
         else sample_weights.to(torch.float32))
    with torch.no_grad():
        den = all_reduce_sum(w.sum(), group)
    return (per * w).sum() / torch.clamp(den, min=1.0)
