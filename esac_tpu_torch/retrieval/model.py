"""Retriever model: image -> scene embedding -> posterior over scenes (the
port of ``esac_tpu/retrieval/model.py``).

ESAC's gating CNN one level up: where ``models/gating.py`` distributes
hypotheses over the experts *within* a scene, the retriever distributes an
image-only request over the *scenes of the whole fleet*.  Same conv trunk
shape, but the head emits an L2-normalized embedding instead of fixed-arity
logits: scene identities live in a per-scene PROTOTYPE table
(``index.SceneIndex``) that is a tensor ARGUMENT of the one forward --
padded to a static ``max_scenes`` axis and masked, so enrolling and
removing scenes never changes the forward's batch signature.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from esac_tpu_torch.models.expert import conv_epilogue
from esac_tpu_torch.ransac.kernel import as_f32
from esac_tpu_torch.serve.batching import count_signatures
from esac_tpu_torch.utils.num import safe_norm
from esac_tpu_torch.utils.precision import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Static-shape config of the retrieval front.

    ``max_scenes`` is the padded prototype axis -- the fleet can enroll at
    most this many scenes under one batch signature; raising it is a new
    signature (made at attach time, never on the request path).
    ``temperature`` scales the cosine logits before the softmax (lower =
    sharper posterior)."""

    height: int = 64
    width: int = 64
    max_scenes: int = 64
    embed_dim: int = 32
    channels: tuple[int, ...] = (16, 32, 64)
    compute_dtype: str = "float32"
    temperature: float = 0.1

    def __post_init__(self):
        if self.height < 1 or self.width < 1:
            raise ValueError(f"bad retrieval input {self.height}x{self.width}")
        if self.max_scenes < 1:
            raise ValueError(f"max_scenes {self.max_scenes} < 1")
        if self.embed_dim < 1:
            raise ValueError(f"embed_dim {self.embed_dim} < 1")
        if not self.channels:
            raise ValueError("channels must be non-empty")
        if not self.temperature > 0.0:
            raise ValueError(f"temperature {self.temperature} must be > 0")


class RetrieverNet(nn.Module):
    """CNN embedder: RGB (..., H, W, 3) NHWC -> unit embedding (..., D).

    The ``models/gating.py`` trunk (per channel count a stride-2 3x3 conv
    and a 3x3 conv, in ``compute_dtype`` with float32 parameters, then a
    global average pool) with an embedding head of two float32 linear
    layers; the output is L2-normalized with the eps inside the sqrt
    (``utils.num.safe_norm``) so an all-zero activation stays finite.
    Layer order follows the Flax module's call order (``Conv_k`` then
    ``Dense_0``, ``Dense_1``)."""

    def __init__(self, embed_dim: int, channels: Sequence[int] = (16, 32, 64),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        convs, cin = [], 3
        for ch in channels:
            convs += [nn.Conv2d(cin, ch, 3, stride=2, padding=1),
                      nn.Conv2d(ch, ch, 3, padding=1)]
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.dense0 = nn.Linear(cin, max(embed_dim * 2, 64))
        self.dense1 = nn.Linear(max(embed_dim * 2, 64), embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2).to(self.compute_dtype)
        for conv in self.convs:
            x = conv_epilogue(conv, x)
        x = x.mean(dim=(2, 3)).float()  # global average pool
        x = self.dense1(F.relu(self.dense0(x)))
        x = x / safe_norm(x, dim=-1)[..., None]
        return x.reshape(lead + x.shape[1:])


# Large-negative logit for masked prototype slots: the softmax weight
# underflows to exactly 0.0 in float32 without the inf - inf NaNs -inf
# logits would produce.
_MASKED_LOGIT = -1e30


def build_retriever(config: RetrievalConfig, seed: int = 0, device=None) -> RetrieverNet:
    """A retriever with PyTorch's default layer init under a forked RNG
    seeded with ``seed`` (the global RNG is left as it was), in eval mode on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = RetrieverNet(config.embed_dim, tuple(config.channels),
                           _DTYPES[config.compute_dtype])
    return net.to(dev).eval()


def make_retrieval_fn(config: RetrievalConfig, device=None):
    """ONE forward for the whole retrieval front:

    ``fn(params, prototypes, mask, images) -> {"embedding", "posterior"}``

    - ``params`` is the :class:`RetrieverNet` (:func:`build_retriever`, or
      weights from ``models.convert.load_retriever``);
    - ``prototypes`` (max_scenes, D) and ``mask`` (max_scenes,) are tensor
      arguments -- enrolling or removing a scene re-runs the SAME batch
      signature;
    - ``images`` is (B, H, W, 3); static shapes throughout, no
      data-dependent control flow.

    Runs under ``torch.inference_mode`` on ``device`` (``None`` = the card).
    The returned fn exposes ``_cache_size()``, the count of distinct batch
    signatures it ran (the bucket functions' convention)."""
    dev = resolve_device(device)
    temperature = torch.tensor(config.temperature, dtype=torch.float32, device=dev)

    def run(params: RetrieverNet, batch: dict) -> dict:
        with torch.inference_mode():
            emb = params(as_f32(batch["images"], dev))                  # (B, D) unit
            logits = emb @ as_f32(batch["prototypes"], dev).T / temperature
            mask = torch.as_tensor(batch["mask"], device=dev).bool()
            logits = torch.where(mask[None, :], logits, _MASKED_LOGIT)
            return {"embedding": emb, "posterior": torch.softmax(logits, dim=-1)}

    counted = count_signatures(run)

    def fn(params, prototypes, mask, images):
        return counted(params, {"prototypes": prototypes, "mask": mask, "images": images})

    fn._cache_size = counted._cache_size
    return fn
