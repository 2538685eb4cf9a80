"""Scene retrieval front-end: image-only requests resolve "which scene am I
in?" through a coarse retriever posterior before the fleet's expert
dispatch.  See model.py (the forward), index.py (the prototype table),
front.py (candidate policy + accounting) and errors.py (the typed miss
family); fleet/router.py's ``infer_image`` is the request path over them."""

from esac_tpu_torch.retrieval.errors import (
    RetrievalCandidatesExhaustedError,
    RetrievalMissError,
)
from esac_tpu_torch.retrieval.front import (
    RetrievalDecision,
    RetrievalFront,
    RetrievalPolicy,
)
from esac_tpu_torch.retrieval.index import SceneIndex
from esac_tpu_torch.retrieval.model import (
    RetrievalConfig,
    RetrieverNet,
    build_retriever,
    make_retrieval_fn,
)

__all__ = [
    "RetrievalCandidatesExhaustedError",
    "RetrievalConfig",
    "RetrievalDecision",
    "RetrievalFront",
    "RetrievalMissError",
    "RetrievalPolicy",
    "RetrieverNet",
    "SceneIndex",
    "build_retriever",
    "make_retrieval_fn",
]
