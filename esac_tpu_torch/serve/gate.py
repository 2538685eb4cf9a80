"""The process-wide dispatch gate: prefetch work yields to dispatches in
flight.

A dispatch of the port is a stream of a few hundred eager ops, and each op
releases the GIL and takes it back.  Any other thread of the process that
runs Python takes the GIL at every one of those op boundaries, so a
prefetcher loading and staging weights beside a dispatch stretches it many
times over (``tools/dispatch_convoy.py``).  The JAX package's dispatch is
one compiled call that gives up the GIL once and needs no gate.

- **Dispatches hold the gate.**  ``MicroBatchDispatcher`` holds it around
  each dispatch, ``parallel.multihost.lead`` around each led call and the
  fleet router around the retrieval front's forward.  It counts holders;
  one process may run several replicas' dispatchers, and each prefetcher
  yields to all of them.  A hold nested in one of the same thread (a led
  call inside a dispatcher's call) adds nothing: one dispatch, one hold.
- **Prefetch steps wait for it to open.**  :func:`yield_to_dispatches`
  marks the steps of a load (a checkpoint read, a checksum, a leaf's copy
  or compression, an expert's ``load_state_dict``, a prefetch cycle's
  start).  In a :func:`prefetching` scope (issuer "prefetch",
  ``obs.trace``) it waits until no dispatch is in flight; anywhere else it
  returns at once, so a demand load never waits.  A dispatch that starts
  during a step is stretched by that one step.
- **Coalesced demand never deadlocks.**  A dispatch that misses on a key
  whose load the prefetcher owns waits on that load's future.  It marks
  the future demanded (:func:`demand`), and a step of a load whose owned
  futures (:func:`owning`) include a demanded one does not wait.
- **Wedges do not starve prefetch.**  :meth:`DispatchGate.leave` is
  idempotent and may come first: the SLO watchdog retires the token of a
  dispatch it abandons, and a later enter or leave of that token does
  nothing.  Since a dispatch holds once, retiring its token opens the gate
  even while the wedged call sits inside a led call.
- **Closing never waits on the gate.**  A :func:`prefetching` scope
  carries its prefetcher's closing event, and its steps stop waiting once
  the event is set.

Under continuous traffic a prefetcher may wait up to :data:`MAX_YIELD_S` a
step; a demand fault still loads on its own path, as it does in the JAX
package.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

from esac_tpu_torch.obs.trace import current_issuer, issuer_scope

# This thread's hold, as (gate, token); the load futures it owns
# (innermost last); the closing event of the prefetcher it runs for.
_HOLD: contextvars.ContextVar = contextvars.ContextVar("esac_gate_hold", default=None)
_OWNED: contextvars.ContextVar = contextvars.ContextVar("esac_gate_owned", default=())
_CLOSING: contextvars.ContextVar = contextvars.ContextVar("esac_gate_closing", default=None)

# The longest one prefetch step waits, in seconds (None: no limit).  A
# dispatcher without an SLO watchdog never retires the hold of a dispatch
# wedged inside its call, and without a limit that one wedge would stop
# every prefetcher of the process for good.  It is longer than any
# watchdog the repo configures (500-5000 ms), so a wedge under a watchdog
# is retired first, and a dispatch of the full-width presets (~20-170 ms on
# the H100) never reaches it.
MAX_YIELD_S: float | None = 10.0


class GateToken:
    """One hold of the gate: new, held, then left (never held again)."""

    __slots__ = ("state",)

    def __init__(self):
        self.state = "new"


class DispatchGate:
    """Counts the dispatches in flight; :meth:`wait_idle` blocks until
    there are none or a release check is true."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._held = 0
        self.waits = 0  # prefetch steps that found a dispatch in flight

    def enter(self, token: GateToken | None = None) -> GateToken:
        """Hold the gate with ``token`` (a new one by default); a token
        already left stays out."""
        token = GateToken() if token is None else token
        with self._cond:
            if token.state == "new":
                token.state = "held"
                self._held += 1
        return token

    def leave(self, token: GateToken) -> None:
        """Release ``token``'s hold; idempotent, and a token left before
        it was entered is retired."""
        with self._cond:
            if token.state == "held":
                self._held -= 1
                if self._held == 0:
                    self._cond.notify_all()
            token.state = "left"

    @contextlib.contextmanager
    def held(self, token: GateToken | None = None):
        """Hold the gate for the scope, unless this thread already holds
        it: then the scope rides the outer hold and its token."""
        outer = _HOLD.get()
        if outer is not None and outer[0] is self:
            yield outer[1]
            return
        token = self.enter(token)
        ctx = _HOLD.set((self, token))
        try:
            yield token
        finally:
            _HOLD.reset(ctx)
            self.leave(token)

    def in_flight(self) -> int:
        with self._cond:
            return self._held

    def wake(self) -> None:
        """Wake every waiter to re-read its release check."""
        with self._cond:
            self._cond.notify_all()

    def wait_idle(self, released=lambda: False, timeout_s: float | None = None) -> bool:
        """Block until no dispatch holds the gate or ``released()``, for
        at most ``timeout_s`` (None: no limit); False if it timed out."""
        with self._cond:
            if not self._held or released():
                return True
            self.waits += 1
            end = None if timeout_s is None else time.monotonic() + timeout_s
            while self._held and not released():
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
            return True


DISPATCH_GATE = DispatchGate()


@contextlib.contextmanager
def owning(fut: dict):
    """Mark the load future ``fut`` as this thread's while it runs."""
    token = _OWNED.set(_OWNED.get() + (fut,))
    try:
        yield
    finally:
        _OWNED.reset(token)


def demand(fut: dict) -> None:
    """A demand waiter joined ``fut``: its owner's steps stop yielding."""
    if not fut.get("demanded"):
        fut["demanded"] = True
        DISPATCH_GATE.wake()


@contextlib.contextmanager
def prefetching(closing: threading.Event):
    """Run a prefetch cycle: its loads' issuer is "prefetch", and its steps
    stop waiting once ``closing`` is set (wake the gate after setting it)."""
    with issuer_scope("prefetch"):
        token = _CLOSING.set(closing)
        try:
            yield
        finally:
            _CLOSING.reset(token)


def yield_to_dispatches() -> None:
    """One prefetch step's yield point (module docstring): returns at once
    unless this thread's issuer is "prefetch"."""
    if current_issuer() != "prefetch":
        return
    owned, closing = _OWNED.get(), _CLOSING.get()

    def released():
        return ((closing is not None and closing.is_set())
                or any(f.get("demanded") for f in owned))

    DISPATCH_GATE.wait_idle(released, MAX_YIELD_S)
