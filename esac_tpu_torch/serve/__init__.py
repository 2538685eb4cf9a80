"""The serving front end: bucketed batching and staging, the micro-batching
dispatcher, the SLO layer, the open-loop load generator and tracked
sessions."""

from esac_tpu_torch.serve.session import (
    SessionEvictedError,
    SessionPolicy,
    SessionRouter,
    SessionTable,
    SessionUnknownError,
)

__all__ = [
    "SessionEvictedError",
    "SessionPolicy",
    "SessionRouter",
    "SessionTable",
    "SessionUnknownError",
]
