"""The hook through which a step counter (``launch/roofline.py::count_step``)
accounts for a hand-written kernel's wrapper.

A counter that counts aten ops would see a wrapper's insides, and those
differ by device: on the card a ``ctypes`` launch that aten never sees
(plus the wrapper's own allocations), on the CPU the plain version's aten
ops.  So a wrapper decorated with :func:`accounted` is counted by its
formula, the work the kernel does for these inputs, and the counter does
not descend into it on either branch.  Outside a counter the decorator
only calls the wrapper.
"""
from __future__ import annotations

import functools

from torch.utils._python_dispatch import _get_current_dispatch_mode


def accounted(formula, out_like):
    """Decorate a kernel wrapper.  ``formula(*args, positions=..., **kwargs)
    -> (flops, bytes)``: the kernel's operations and the bytes it must move
    (each input read once, each output written once); ``positions`` is the
    counter's host-side decode position, for a wrapper whose position is a
    device tensor.  ``out_like(*args, **kwargs)``: empty outputs with the
    wrapper's shapes, dtypes and layout, which a counter on the ``meta``
    device returns in place of running the wrapper (its plain version may
    read a value a meta tensor does not have)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            account = getattr(_get_current_dispatch_mode(), "account_kernel",
                              None)
            if account is None:
                return fn(*args, **kwargs)
            return account(wrapper.__name__, fn, formula, out_like, args,
                           kwargs)
        return wrapper
    return deco
