"""Memory-overlap analysis for strided views.

Counterpart of kfunca_tpu/core/overlap.py (pure Python, carried over as it
is).  Rebuild of the reference overlap math
(the reference's src/core/utils/memory/memory_overlap.h:10-61):

  * is_non_overlapping_and_dense — every element has a unique address and
    the addresses form a dense block (sort dims by stride, check the
    running product).  Gates zero-copy fast paths in the layout engine.
  * offset_range — [min, max] element offsets a view can touch (storage is
    sized from this, reference tensor_impl.cpp:57-65).
  * may_self_overlap — a view that maps two index tuples to one address
    (stride 0 on a >1 dim, or interleaved strides).  Writing through such a
    view is rejected: on GPU it is a data race, on TPU a nondeterministic
    scatter.

The port's ops compute a fresh result before they write it through the
out= view (an input that shares memory with the target is copied first,
core/materialize.py), so the reference's *partial* input/output overlap
hazard (is_no_partial_overlap) cannot produce torn reads; self-overlapping
*writes* remain the one genuine hazard and are checked at every write.
"""

from __future__ import annotations


def offset_range(shape, strides) -> tuple[int, int]:
    """(min, max) relative element offsets reachable by the view."""
    lo = hi = 0
    for n, s in zip(shape, strides):
        if n == 0:
            return (0, 0)
        span = (int(n) - 1) * int(s)
        if span >= 0:
            hi += span
        else:
            lo += span
    return lo, hi


def is_non_overlapping_and_dense(shape, strides) -> bool:
    """True when the view is a permutation of a contiguous block."""
    dims = [(int(s), int(n)) for n, s in zip(shape, strides) if int(n) != 1]
    dims.sort()  # ascending stride
    expect = 1
    for stride, extent in dims:
        if stride != expect:
            return False
        expect *= extent
    return True


def may_self_overlap(shape, strides) -> bool:
    """Conservatively true when two index tuples can alias one address.

    Exact for the layouts our view ops produce (sorted strides with
    per-level capacity check); stride-0 broadcast dims always overlap.
    """
    dims = [(abs(int(s)), int(n)) for n, s in zip(shape, strides) if int(n) > 1]
    for s, _ in dims:
        if s == 0:
            return True
    dims.sort()
    span = 1  # addresses touched by all finer dims
    for stride, extent in dims:
        if stride < span:
            return True
        span = stride * (extent - 1) + span
    return False
