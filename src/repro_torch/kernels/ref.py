"""Plain PyTorch versions of the kernels (the allclose ground truth).

Each repeats its kernel's arithmetic with plain tensor operations in f32:
the conv shard is a sum over the K*K taps of ``[Ho*Wo, Cin] @ [Cin, Cout]``
products (a broadcast multiply for depthwise), as the TPU kernel computes
it, the FC shard is one f32 matrix product, and the two attention kernels
are a masked softmax over the whole score row (paged decode: over the live
pages gathered by table).  The wrappers in
:mod:`repro_torch.kernels.conv2d`, :mod:`repro_torch.kernels.ops` and
:mod:`repro_torch.kernels.flash_attention` run these for tensors that lie
on the CPU; on the card they are the versions the kernels are held
against.  Layouts are the engine's: activations ``[H, W, C]``, conv
weights HWIO, depthwise weights ``[K, K, 1, C]``; attention ``[..., S,
hd]`` and paged pools ``[BH, P, page_size, hd]``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

#: the finite mask value of the reference's attention kernels: a block
#: that is masked in full gives a correction exp(NEG_INF - m) of 0, never
#: a NaN
NEG_INF = -1e30


def conv2d_shard_ref(x: torch.Tensor, w: torch.Tensor, *,
                     pads: Tuple[int, int, int, int] = (0, 0, 0, 0),
                     stride: int = 1,
                     depthwise: bool = False) -> torch.Tensor:
    """Shard-layout conv with per-side zero ``pads`` (top, bottom, left,
    right): x ``[Hl, Wl, Cin]``, w ``[K, K, Cin, Cout]`` (depthwise
    ``[K, K, 1, C]``) -> ``[Ho, Wo, Cout]``."""
    pt, pb, pl_, pr = pads
    k = w.shape[0]
    xp = F.pad(x.float(), (0, 0, pl_, pr, pt, pb))
    hp, wp, cin = xp.shape
    ho = max(0, (hp - k) // stride + 1)
    wo = max(0, (wp - k) // stride + 1)
    cout = cin if depthwise else w.shape[3]
    wf = w.float()
    acc = torch.zeros((ho, wo, cout), dtype=torch.float32, device=x.device)
    for kh in range(k):
        for kw in range(k):
            xs = xp[kh:kh + (ho - 1) * stride + 1:stride,
                    kw:kw + (wo - 1) * stride + 1:stride, :]
            if depthwise:
                acc += xs * wf[kh, kw, 0]
            else:
                acc += (xs.reshape(ho * wo, cin) @ wf[kh, kw]).reshape(
                    ho, wo, cout)
    return acc.to(x.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
               stride: int = 1) -> torch.Tensor:
    """x: [H, W, Cin]; w: [K, K, Cin, Cout], symmetric ``padding``."""
    return conv2d_shard_ref(x, w, pads=(padding,) * 4, stride=stride)


def dwconv2d_ref(x: torch.Tensor, w: torch.Tensor, *, padding: int = 0,
                 stride: int = 1) -> torch.Tensor:
    """Depthwise: x [H, W, C]; w [K, K, 1, C], symmetric ``padding``."""
    return conv2d_shard_ref(x, w, pads=(padding,) * 4, stride=stride,
                            depthwise=True)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, Cin] @ w: [Cin, Cout] in f32 accumulation."""
    return (x.float() @ w.float()).to(x.dtype)


def live_pages(kv_len: int, page_size: int,
               window: Optional[int] = None) -> Tuple[int, int]:
    """Logical pages ``lo .. hi - 1`` that a paged decode over ``kv_len``
    keys reads: ``hi = ceil(kv_len / page_size)``, and a window's lower
    bound ``kv_len - window`` floored to the start of its page."""
    hi = -(-kv_len // page_size)
    lo = 0 if window is None else max(0, (kv_len - window) // page_size)
    return lo, hi


def flash_decode_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table, kv_len,
                           *, window: Optional[int] = None,
                           scale: Optional[float] = None,
                           groups: int = 1) -> torch.Tensor:
    """Single-query attention over a paged KV cache: ``q`` [BH, hd],
    pools [BH / groups, P, ps, hd], ``page_table`` [n_logical] (tensor or
    array); query row ``bh`` reads pool row ``bh // groups``, so the call
    is the ungrouped one on pools repeated ``groups`` times along their
    first axis.  Gathers the live logical pages by table, masks the
    positions at or past ``kv_len`` and outside the window with
    :data:`NEG_INF`, then softmax in f32; the output is in ``q``'s dtype.
    Pages outside ``lo .. hi - 1`` are never read.

    ``kv_len`` is an int or a one-element tensor.  A CUDA tensor is not
    read on the host (no sync, so a decode step that holds this call can
    be captured in a CUDA graph): every page of the table is gathered, and
    the keys outside the live range get :data:`NEG_INF` scores and zero
    values, so what lies in a dead page does not reach the output."""
    hd = q.shape[1]
    ps = k_pages.shape[2]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    if isinstance(kv_len, torch.Tensor) and kv_len.is_cuda:
        return _decode_masked(q, k_pages, v_pages, page_table,
                              kv_len.reshape(()), window, scale, groups)
    kv_len = int(kv_len)
    lo, hi = live_pages(kv_len, ps, window)
    if hi <= lo:
        return torch.zeros_like(q)
    table = torch.as_tensor(page_table, device=k_pages.device)
    phys = table[lo:hi].long()
    k = _gather_rows(k_pages, phys, groups)
    v = _gather_rows(v_pages, phys, groups)
    s = torch.einsum("hd,htd->ht", q.float(), k) * scale
    pos = lo * ps + torch.arange(k.shape[1], device=q.device)
    valid = pos < kv_len
    if window is not None:
        valid &= pos > kv_len - 1 - window
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    return torch.einsum("ht,htd->hd", p, v).to(q.dtype)


def _gather_rows(pages: torch.Tensor, phys: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """The pages ``phys`` of every pool row as f32 ``[rows * groups, keys,
    hd]``, each pool row repeated for its ``groups`` query rows."""
    rows = pages[:, phys].reshape(pages.shape[0], -1, pages.shape[3]).float()
    return rows if groups == 1 else rows.repeat_interleave(groups, dim=0)


def _decode_masked(q, k_pages, v_pages, page_table, kv_len, window, scale,
                   groups=1):
    """:func:`flash_decode_paged_ref` over the whole table, with the live
    range taken from the device scalar ``kv_len``."""
    table = torch.as_tensor(page_table, device=k_pages.device).long()
    k = _gather_rows(k_pages, table, groups)
    v = _gather_rows(v_pages, table, groups)
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos < kv_len
    if window is not None:
        valid &= pos > kv_len - 1 - window
    s = torch.einsum("hd,htd->ht", q.float(), k) * scale
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    v = torch.where(valid[None, :, None], v, 0.0)
    return torch.einsum("ht,htd->hd", p, v).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Naive masked softmax attention in f32: ``q`` [..., H, S, hd], ``k``
    and ``v`` [..., KV, S, hd] with ``H % KV == 0`` (query head ``h`` reads
    kv head ``h // (H / KV)``).  Causal and sliding-window masks as the
    kernel's; the output is in the input dtype.  ``return_lse`` also
    returns each row's f32 log-sum-exp of its masked scores ``[..., H,
    S]``, as the kernel does."""
    S, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    rep = q.shape[-3] // k.shape[-3]
    kf = k.float().repeat_interleave(rep, dim=-3)
    vf = v.float().repeat_interleave(rep, dim=-3)
    s = q.float() @ kf.transpose(-1, -2) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask, s, NEG_INF)
    out = (torch.softmax(s, dim=-1) @ vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out
