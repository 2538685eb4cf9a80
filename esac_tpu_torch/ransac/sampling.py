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
