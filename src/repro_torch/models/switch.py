"""One kernel's impl switch, with a pin local to the calling thread.

Each kernel path of the models (RMSNorm, causal attention, the SSD scan)
runs ``"plain"`` (the plain PyTorch version), ``"cuda"`` (the hand-written
kernel) or, when its switch is None, the kernel on card tensors and the
plain version on CPU tensors.

``set`` changes the process-wide setting. ``pinned`` overrides it inside a
scope for the calling thread only: the pin is a ``ContextVar``, so scopes
that overlap in several threads (the gateway traces cold queries on a pool
of threads, each tracing with every kernel pinned plain) neither see nor
undo each other's pins, and a card job in another thread keeps its own
impl while a trace is in flight.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

IMPLS = ("plain", "cuda")
_UNPINNED = object()
SWITCHES: Dict[str, "ImplSwitch"] = {}  # name -> switch, filled as the model modules load


class ImplSwitch:
    """The impl of one kernel path: a process-wide setting and a per-thread pin."""

    def __init__(self, name: str):
        self.name = name
        self._impl: Optional[str] = None
        self._pin = contextvars.ContextVar(f"{name}_impl_pin", default=_UNPINNED)
        SWITCHES[name] = self

    def check(self, impl: Optional[str]) -> Optional[str]:
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"{self.name} impl {impl!r} not in {IMPLS} or None")
        return impl

    def set(self, impl: Optional[str]) -> None:
        """The process-wide setting, in force wherever no pin is."""
        self._impl = self.check(impl)

    def get(self) -> Optional[str]:
        """The impl in force in the calling thread: its pin, else the setting."""
        pin = self._pin.get()
        return self._impl if pin is _UNPINNED else pin

    @contextlib.contextmanager
    def pinned(self, impl: Optional[str]) -> Iterator[None]:
        """Pin ``impl`` for the calling thread inside the scope."""
        token = self._pin.set(self.check(impl))
        try:
            yield
        finally:
            self._pin.reset(token)

    def use_kernel(self, x) -> bool:
        """Whether the path runs its kernel on ``x``; raises when ``"cuda"`` is
        asked for with a tensor off the card."""
        impl = self.get()
        if impl == "cuda":
            if not x.is_cuda:
                raise ValueError(f"{self.name} impl 'cuda' asked for with tensors on "
                                 f"{x.device}; the kernel runs on the card only")
            return True
        return impl is None and x.is_cuda


def with_the_impls_in_force(fn):
    """``fn`` pinned, wherever it runs, to every switch's impl in force here
    and now. A remat region is recomputed during the backward, which
    autograd runs on its own thread for card tensors; that thread sees none
    of this thread's pins, and the recompute must take the forward's path
    (the train step pins attention plain: the flash kernel has no
    backward)."""
    impls = [(switch, switch.get()) for switch in SWITCHES.values()]

    def run(*args):
        with contextlib.ExitStack() as pins:
            for switch, impl in impls:
                pins.enter_context(switch.pinned(impl))
            return fn(*args)
    return run
