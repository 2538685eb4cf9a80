"""Typed faults of the retrieval front-end (the port of
``esac_tpu/retrieval/errors.py``).

Both classes derive from the :class:`~esac_tpu_torch.serve.slo.ServeError`
root and declare ``retryable`` + ``wire_name`` as the JAX package's do.
"""

from __future__ import annotations

from esac_tpu_torch.serve.slo import ShedError


class RetrievalMissError(ShedError):
    """The retrieval front could not produce a dispatchable candidate
    set for an image-only request: the posterior's top-1 confidence sat
    below ``RetrievalPolicy.min_confidence``, the index had no enrolled
    scene, or every candidate inside the fan-out was breaker-tripped.
    The request is rejected BEFORE any expert dispatch — a shed at the
    retrieval admission tier, so callers that only distinguish
    *admitted vs not* can keep catching :class:`ShedError`."""

    # Deterministic for the same frame against the same index/breaker
    # state: re-submitting the identical image cannot clear a
    # low-confidence posterior.
    retryable = False
    wire_name = "retrieval_miss"


class RetrievalCandidatesExhaustedError(RetrievalMissError):
    """Retrieval produced a healthy candidate set but every candidate's
    expert dispatch failed (typed, per-candidate) before any winner
    could be scored.  Unlike its parent this happens AFTER admission —
    the image request lands in the ``failed`` outcome class, and the
    per-candidate fleet requests carry their own books."""

    # Retryable: the candidates failed for serving reasons (fault
    # injection, transient replica faults) — a re-submit can route to
    # recovered candidates.
    retryable = True
    wire_name = "retrieval_candidates_exhausted"
