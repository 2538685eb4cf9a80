"""Correspondence-set sampling (counterpart of ``esac_tpu/ransac/sampling.py``).

The same contract as the JAX package -- independent uniform cell indices,
with replacement; a collided (degenerate) set is rejected by the solver's
branch penalties and by scoring, not by resampling -- drawn from an explicit
``torch.Generator``.  Its numbers cannot match JAX's threefry stream; the
tests inject the same index table into both packages instead.
"""

from __future__ import annotations

import torch


def sample_correspondence_sets(
    generator: torch.Generator,
    n_hyps: int,
    n_cells: int,
    batch_shape: tuple[int, ...] = (),
    set_size: int = 4,
) -> torch.Tensor:
    """Draw ``batch_shape + (n_hyps, set_size)`` int64 indices in
    [0, n_cells) on the generator's device."""
    return torch.randint(
        0, n_cells, tuple(batch_shape) + (n_hyps, set_size),
        generator=generator, device=generator.device,
    )


def sample_correspondence_sets_exact(
    generator: torch.Generator,
    n_hyps: int,
    n_cells: int,
    batch_shape: tuple[int, ...] = (),
    set_size: int = 4,
) -> torch.Tensor:
    """The exact without-replacement variant (counterpart of
    ``sample_correspondence_sets_exact``, Gumbel-top-k): each set is the
    ``set_size`` largest of ``n_cells`` Gumbel draws, so its indices are
    distinct and every cell is equally likely.  Costs a length-``n_cells``
    top-k per hypothesis; for tests, not the default.  Returns
    ``batch_shape + (n_hyps, set_size)`` int64 on the generator's device."""
    shape = tuple(batch_shape) + (n_hyps, n_cells)
    u = torch.rand(shape, generator=generator, device=generator.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.topk(gumbel, set_size, dim=-1).indices


def sample_expert_indices(
    generator: torch.Generator,
    gating_probs: torch.Tensor,
    n_hyps: int,
) -> torch.Tensor:
    """Draw one expert per hypothesis from the gating distribution
    (counterpart of ``sample_expert_indices``): a categorical draw over
    ``log(gating_probs + 1e-12)``, i.e. with probabilities proportional to
    ``gating_probs + 1e-12``.  gating_probs (M,) -> (n_hyps,) int64 on the
    generator's device; not differentiable (the draw's gradient is the
    REINFORCE term of ``esac_train_loss``)."""
    w = (gating_probs.detach().float() + 1e-12).to(generator.device)
    return torch.multinomial(w, n_hyps, replacement=True, generator=generator)
