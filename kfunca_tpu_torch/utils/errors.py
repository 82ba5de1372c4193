"""Error infrastructure (counterpart of kfunca_tpu/utils/errors.py).

The reference's CHECK_FAIL throws utils::Error carrying function/file/line
plus a variadic message.  Here the same contract is a KfError that captures
the failing call site from the Python stack.
"""

from __future__ import annotations

import traceback


class KfError(RuntimeError):
    """Framework check failure with captured call-site context."""

    def __init__(self, *msg_parts):
        # the frame that called check(): two frames up (check -> KfError)
        stack = traceback.extract_stack(limit=4)
        site = stack[0] if len(stack) >= 4 else None
        msg = " ".join(str(m) for m in msg_parts)
        if site is not None:
            msg = f"{msg}\n  at {site.filename}:{site.lineno} in {site.name}"
        super().__init__(msg)


def check(cond, *msg) -> None:
    """CHECK_FAIL analog: raise KfError with context when cond is false."""
    if not cond:
        raise KfError(*msg) from None
