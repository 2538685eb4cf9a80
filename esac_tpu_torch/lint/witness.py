"""Runtime witnesses: the dynamic halves of the committed-artifact gates
(counterpart of ``esac_tpu/lint/witness.py``).

:class:`LockWitness` is the dynamic half of R12/R13 against
``esac_tpu_torch/lint/lock_graph.json``; :class:`OutcomeWitness` the
dynamic half of R16 against ``esac_tpu_torch/lint/fault_taxonomy.json``
(every error type a drill observes must be a committed taxonomy member,
and every observed (error type, outcome) pair must ride a committed
raise -> outcome edge).  Production code never imports this module:
tests and ``chip_smoke.py`` attach a witness, run the fleet, and hold the
trail against the committed artifact.

A :class:`LockWitness` wraps the fleet's ``threading.Lock`` objects
(Conditions are rebuilt over the wrapped lock, so the dispatcher's
``_work`` / ``_space`` aliases keep sharing one lock) and records:

- **acquisition edges** -- each time a thread acquires lock B while
  holding lock A, keyed by the static node ids (``Class.attr``,
  instance-collapsed), so :meth:`LockWitness.violations` can require the
  observed edge set to be a subgraph of the committed order's transitive
  closure;
- **hold times** -- per-node streaming histograms
  (:class:`~esac_tpu_torch.obs.metrics.StreamingHistogram`), published
  into an obs registry by :meth:`LockWitness.bind_obs`;
- **blocked-while-held events** -- an acquire that waited more than
  ``blocked_threshold_s`` while the thread already held another witnessed
  lock: the runtime shadow of an R13 finding.

Attach after construction and before any worker thread starts (wrapping a
lock a thread waits on would strand it):
``MicroBatchDispatcher(start_worker=False)``, then ``attach``, then
``start()``.  The witness's own bookkeeping lock is not witnessed, and
recording takes no witnessed lock.
"""

from __future__ import annotations

import collections
import threading
import time

from esac_tpu_torch.obs.metrics import StreamingHistogram


class WitnessLock:
    """Proxy around a ``threading.Lock`` that reports to a witness.

    Implements the lock protocol ``threading.Condition`` relies on
    (``acquire``/``release``/context manager; no ``_release_save`` /
    ``_is_owned`` overrides, so Condition falls back to plain
    release/acquire through THIS proxy and the witness sees a
    coalescing wait as release -> reacquire, exactly what happens)."""

    __slots__ = ("_raw", "_witness", "name")

    def __init__(self, raw, name: str, witness: "LockWitness"):
        self._raw = raw
        self.name = name
        self._witness = witness

    def acquire(self, blocking=True, timeout=-1):
        t0 = time.perf_counter()
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            self._witness._acquired(self.name, time.perf_counter() - t0)
        return ok

    def release(self):
        self._witness._released(self.name)
        self._raw.release()

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<WitnessLock {self.name} over {self._raw!r}>"


class LockWitness:
    """Records acquisition edges, hold times, and blocked-while-held
    events across every lock wrapped through :meth:`wrap`/:meth:`attach`
    (see the module docstring for the attach-before-start contract)."""

    def __init__(self, blocked_threshold_s: float = 1e-3):
        self._mu = threading.Lock()   # witness-internal; never witnessed
        self._tls = threading.local()
        self._edges: collections.Counter = collections.Counter()
        self._holds: dict[str, StreamingHistogram] = {}
        self._blocked: collections.deque = collections.deque(maxlen=1000)
        self._thresh = blocked_threshold_s

    # ---- wrapping ----

    def wrap(self, raw, name: str) -> WitnessLock:
        if isinstance(raw, WitnessLock):
            return raw
        return WitnessLock(raw, name, self)

    def attach(self, obj, *attrs) -> "LockWitness":
        """Wrap ``obj.<attr>`` in place for each attr, naming the node
        ``type(obj).__name__ + '.' + attr`` — the SAME id the static
        graph uses, instance-collapsed.  Conditions on the instance that
        wrap the raw lock are rebuilt over the proxy, so aliases keep
        aliasing.  Idempotent.  Attach before any thread can hold or
        wait on the lock."""
        for attr in attrs:
            raw = getattr(obj, attr)
            if isinstance(raw, WitnessLock):
                continue
            wrapped = self.wrap(raw, f"{type(obj).__name__}.{attr}")
            setattr(obj, attr, wrapped)
            try:
                items = list(vars(obj).items())
            except TypeError:  # __slots__ classes carry no Conditions here
                items = []
            for other, val in items:
                if isinstance(val, threading.Condition) and \
                        val._lock is raw:
                    setattr(obj, other, threading.Condition(wrapped))
        return self

    def attach_obs(self, metrics) -> "LockWitness":
        """Wrap a :class:`~esac_tpu_torch.obs.MetricsRegistry`'s own lock plus
        every registered instrument's lock, every EXISTING histogram
        child's, and — when attached — the trace store's,
        the timeline's and the rule engine's leaf locks.  Children
        created after attach stay unwrapped — their acquisitions simply
        go unobserved, which only shrinks the observed set (the
        subgraph check is one-sided)."""
        self.attach(metrics, "_lock")
        for inst in list(metrics._metrics.values()):
            self.attach(inst, "_lock")
            for child in list(getattr(inst, "_children", {}).values()):
                self.attach(child, "_lock")
        for attachment in (metrics._trace_store, metrics._timeline,
                           metrics._health_rules):
            if attachment is not None:
                self.attach(attachment, "_lock")
        return self

    def attach_fleet(self, disp=None, registry=None, injector=None,
                     prefetcher=None, router=None,
                     session_router=None) -> "LockWitness":
        """One-call wiring for the shipped fleet shapes: a
        MicroBatchDispatcher (lock + conditions + its obs instruments),
        a SceneRegistry (health/program locks, manifest, weight cache +
        its host tier when attached, its obs registry), a
        WeightPrefetcher, a FleetRouter (its lock, its obs
        registry, and every replica's dispatcher + registry + a tagged
        FaultInjector infer fn; attach BEFORE ``router.start()``, the
        same contract as the dispatcher worker), and optionally a
        FaultInjector.  The
        attach-before-start contract is ENFORCED for the prefetcher: an
        explicitly passed one whose thread is already running raises
        (rebuilding its Condition would strand the live waiter); an
        auto-discovered running one is skipped silently — the subgraph
        check is one-sided, an unwitnessed lock only shrinks the
        observed set."""
        if registry is not None:
            self.attach(registry, "_health_lock", "_fns_lock")
            self.attach(registry.manifest, "_lock")
            self.attach(registry.cache, "_lock")
            if getattr(registry.cache, "tier", None) is not None:
                self.attach(registry.cache.tier, "_lock")
            auto_pf = getattr(registry, "_prefetcher", None)
            if auto_pf is not None and prefetcher is None \
                    and not self._thread_running(auto_pf):
                prefetcher = auto_pf
            self.attach_obs(registry.obs)
        if prefetcher is not None:
            if self._thread_running(prefetcher):
                raise ValueError(
                    "attach the witness BEFORE the prefetcher starts "
                    "(attach_prefetcher(start=False) -> attach_fleet -> "
                    "start()): wrapping a live thread's lock rebuilds "
                    "its Condition under the waiter and strands it"
                )
            self.attach(prefetcher, "_lock")
        if disp is not None:
            self.attach(disp, "_lock")
            self.attach_obs(disp.obs)
        if injector is not None:
            self.attach(injector, "_lock")
        if router is not None:
            self.attach(router, "_lock")
            self.attach_obs(router.obs)
            for rep in router._replicas.values():
                self.attach_fleet(
                    disp=rep.dispatcher,
                    registry=getattr(rep, "registry", None),
                )
                infer = getattr(rep.dispatcher, "_infer", None)
                if infer is not None and hasattr(infer, "_lock") and \
                        hasattr(infer, "stall_once"):
                    self.attach(infer, "_lock")  # a tagged FaultInjector
            front = getattr(router, "_retrieval", None)
            if front is not None:
                # The retrieval front + its scene index are
                # LEAF locks (taken sequentially, never nested under
                # each other or the router lock).
                self.attach(front, "_lock")
                idx = getattr(front, "_index", None)
                if idx is not None and hasattr(idx, "_lock"):
                    self.attach(idx, "_lock")
        if session_router is not None:
            # The session table is a committed LEAF lock —
            # plan/observe snapshot under it, every dispatch and result
            # wait happens outside (R13), so no edge may ever appear.
            self.attach(session_router.table, "_lock")
        return self

    @staticmethod
    def _thread_running(obj) -> bool:
        t = getattr(obj, "_thread", None)
        return t is not None and t.is_alive()

    # ---- recording (called from WitnessLock; no witnessed lock taken) ----

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _acquired(self, name: str, waited_s: float) -> None:
        st = self._stack()
        if st:
            held = [h for h, _ in st]
            with self._mu:
                for h in held:
                    self._edges[(h, name)] += 1
                if waited_s >= self._thresh:
                    self._blocked.append({
                        "held": held, "wanted": name,
                        "waited_s": round(waited_s, 6),
                    })
        st.append((name, time.perf_counter()))

    def _released(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                _, t0 = st.pop(i)
                hold = time.perf_counter() - t0
                with self._mu:
                    h = self._holds.get(name)
                    if h is None:
                        h = self._holds[name] = StreamingHistogram()
                h.observe(hold)
                return
        # Release with no recorded acquire: the lock was taken before
        # attach. Ignore — bookkeeping starts at the first clean acquire.

    # ---- reading ----

    def edges(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def hold_summary(self) -> dict[str, dict]:
        with self._mu:
            holds = dict(self._holds)
        return {name: holds[name].summary() for name in sorted(holds)}

    def blocked_events(self) -> list[dict]:
        with self._mu:
            return [dict(e) for e in self._blocked]

    def snapshot(self) -> dict:
        """The ``lock_witness`` obs collector payload: observed edges,
        per-lock hold-time summaries, blocked-while-held events."""
        return {
            "edges": {f"{s}->{d}": n for (s, d), n in
                      sorted(self.edges().items())},
            "holds": self.hold_summary(),
            "blocked_while_held": self.blocked_events(),
        }

    def bind_obs(self, metrics, name: str = "lock_witness") -> None:
        """Publish hold-time histograms + observed edges into an obs
        registry as a pull collector."""
        metrics.register_collector(name, self.snapshot)

    # ---- the gate ----

    def violations(self, committed_graph: dict) -> list[str]:
        """Observed edges NOT sanctioned by the committed partial order
        (its transitive closure).  Node ids absent from the committed
        graph are violations too — an unmodeled lock in the nest means
        the static graph is stale."""
        from esac_tpu_torch.lint.lockgraph import transitive_closure

        allowed = transitive_closure(committed_graph.get("edges", []))
        nodes = committed_graph.get("nodes", {})
        out = []
        for (src, dst), n in sorted(self.edges().items()):
            if src not in nodes or dst not in nodes:
                out.append(
                    f"{src}->{dst} (x{n}): lock(s) missing from the "
                    "committed graph nodes"
                )
            elif src == dst and nodes[src].get("kind") == "RLock":
                continue  # reentrant re-acquisition: the static pass
                #           sanctions it ('reentrant by design'), so the
                #           runtime check must not call it a violation
            elif (src, dst) not in allowed:
                out.append(
                    f"{src}->{dst} (x{n}): acquisition order not in the "
                    "committed lock_graph.json partial order"
                )
        return out

    def assert_subgraph(self, committed_graph: dict) -> None:
        v = self.violations(committed_graph)
        if v:
            raise AssertionError(
                "observed lock acquisitions escape the committed order "
                "(regenerate + review lock_graph.json if intentional):\n"
                + "\n".join(v)
            )


class OutcomeWitness:
    """Runtime outcome witness: holds every error type
    and (error type, outcome) pair a drill observes to the committed
    ``esac_tpu_torch/lint/fault_taxonomy.json``.

    The static pass (:mod:`esac_tpu_torch.lint.faultflow`) proves each
    taxonomy error is DISPOSED somewhere — mapped to an accounted
    outcome class via a typed handler, a recorder call, or a broad
    accounting backstop.  This witness checks the same contract on the
    trail a real run leaves behind: ``chip_smoke.py``'s drills feed it
    the loadgen's ``per_request_outcomes`` / ``per_request_error_types``
    arrays, and :meth:`violations` reports

    - an observed error type that is NOT a committed taxonomy member
      (someone minted outside the closed catalog — the runtime shadow
      of an R16 finding), and
    - an observed (error type, outcome) pair outside the committed
      effective edges (direct + taxonomy-ancestor edges + the wildcard
      backstop: :func:`esac_tpu_torch.lint.faultflow.effective_outcomes`) —
      a disposal path the static map does not know about, or an
      outcome string outside the closed vocabulary.

    Requests that finished without an error (``error_type`` None) only
    have their outcome checked against the vocabulary.  Like the lock
    witness, the check is one-sided: a committed edge no drill happens
    to take is stale-report territory for the static differ, never a
    runtime violation."""

    def __init__(self, taxonomy: dict):
        from esac_tpu_torch.lint.faultflow import effective_outcomes

        self._taxonomy = taxonomy
        self._effective = effective_outcomes(taxonomy)
        self._vocabulary = tuple(taxonomy.get("outcome_classes", ()))
        self._mu = threading.Lock()
        self._pairs: collections.Counter = collections.Counter()
        self._error_free: collections.Counter = collections.Counter()

    @classmethod
    def from_repo(cls, root) -> "OutcomeWitness":
        """Build from the committed artifact at ``root`` (raises if it
        is missing — a drill without a committed taxonomy is exactly
        the gap the gate exists to close)."""
        import pathlib

        from esac_tpu_torch.lint.faultflow import FAULT_TAXONOMY_NAME, load_taxonomy

        taxonomy = load_taxonomy(pathlib.Path(root) / FAULT_TAXONOMY_NAME)
        if taxonomy is None:
            raise FileNotFoundError(
                f"no committed {FAULT_TAXONOMY_NAME} under {root}; run "
                "`python -m esac_tpu_torch.lint --write-taxonomy`"
            )
        return cls(taxonomy)

    # ---- recording ----

    def observe(self, error_type: str | None, outcome: str) -> None:
        with self._mu:
            if error_type:
                self._pairs[(error_type, outcome)] += 1
            else:
                self._error_free[outcome] += 1

    def observe_run(self, result: dict) -> "OutcomeWitness":
        """Consume one loadgen summary dict (``run_open_loop`` /
        ``FleetRouter`` drill shape): zips ``per_request_outcomes``
        against ``per_request_error_types``."""
        outcomes = result.get("per_request_outcomes", ())
        err_types = result.get("per_request_error_types", ())
        for outcome, err in zip(outcomes, err_types):
            self.observe(err, outcome)
        return self

    # ---- reading / the gate ----

    def pairs(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._pairs)

    def violations(self) -> list[str]:
        with self._mu:
            pairs = dict(self._pairs)
            error_free = dict(self._error_free)
        out = []
        for (err, outcome), n in sorted(pairs.items()):
            if err not in self._effective:
                out.append(
                    f"{err} (x{n}): observed error type is not a member "
                    "of the committed fault taxonomy"
                )
            elif outcome not in self._effective[err]:
                out.append(
                    f"{err}->{outcome} (x{n}): observed pair rides no "
                    "committed raise->outcome edge (direct, inherited, "
                    "or wildcard)"
                )
        for outcome, n in sorted(error_free.items()):
            if outcome not in self._vocabulary:
                out.append(
                    f"(no error)->{outcome} (x{n}): outcome outside the "
                    "committed vocabulary"
                )
        return out

    def snapshot(self) -> dict:
        """The ``fault_taxonomy`` obs collector / artifact block:
        observed per-(error, outcome) counts, the violation list, and
        the committed catalog size the run was held to."""
        with self._mu:
            pairs = dict(self._pairs)
            error_free = dict(self._error_free)
        return {
            "observed": {f"{e}->{o}": n for (e, o), n in
                         sorted(pairs.items())},
            "error_free_outcomes": {o: n for o, n in
                                    sorted(error_free.items())},
            "violations": self.violations(),
            "committed_errors": len(self._taxonomy.get("errors", {})),
            "committed_edges": len(self._taxonomy.get("edges", [])),
        }

    def bind_obs(self, metrics, name: str = "fault_taxonomy") -> None:
        """Publish the observed error->outcome trail into an obs
        registry as a pull collector (as the lock witness does)."""
        metrics.register_collector(name, self.snapshot)

    def assert_consistent(self) -> None:
        v = self.violations()
        if v:
            raise AssertionError(
                "observed fault flow escapes the committed taxonomy "
                "(regenerate + review fault_taxonomy.json if "
                "intentional):\n" + "\n".join(v)
            )
