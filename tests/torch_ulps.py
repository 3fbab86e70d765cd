"""The one-ulp rule that holds the shard kernels in bf16 and fp16 (and in
f32 under a half weight) against another implementation of the same
function: both convert every element to f32, sum in f32 in their own
order and round the sum once to the output dtype.

Two f32 sums of the same terms in other orders differ by a few f32 ulps
of the terms' magnitudes, so after one rounding each output lies within
one ulp of the other's, except where the sum cancels: an output far
below the sum of ``|x * w|`` over its terms (``mag``) can differ by
more than one of its own ulps.  There the two must agree within
:data:`SUM_SLACK` of ``mag``.  The file imports no JAX, so the card tests
use it too.
"""
import torch

#: how far two f32 sums of the same terms in other orders (or with and
#: without fused multiply-adds) may be apart, as a share of the sum of
#: the terms' magnitudes: each rounding moves a sum by at most an ulp of a
#: partial sum, so a 9-term depthwise sum by up to ~2^-20.8 of it
SUM_SLACK = 2.0 ** -20


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two tensors of one floating dtype:
    the distance of their bit patterns in the dtype's order."""
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    sign = 1 << (8 * a.element_size() - 1)

    def order(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & (sign - 1)), i)
    return (order(a) - order(b)).abs()


def holds_one_ulp(out: torch.Tensor, want: torch.Tensor,
                  mag: torch.Tensor):
    """Asserts ``out`` within one ulp of ``want`` at every element in their
    (equal) dtype, save where the element cancels: there within
    SUM_SLACK of ``mag``.  Returns (the largest ulp distance, the share
    of elements that differ)."""
    assert out.dtype == want.dtype, (out.dtype, want.dtype)
    assert out.shape == want.shape, (out.shape, want.shape)
    u = ulps(out, want)
    near = (out.float() - want.float()).abs() <= SUM_SLACK * mag.float()
    bad = int(((u > 1) & ~near).sum())
    assert bad == 0, f"{bad} of {u.numel()} elements past one ulp " \
                     f"(largest {int(u.max())} ulps)"
    if not u.numel():
        return 0, 0.0
    return int(u.max()), float((u > 0).double().mean())
