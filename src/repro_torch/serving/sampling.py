"""Token selection of the engine's steps (port of the reference's
``_sample_traced``, ``repro.serving.engine``): greedy where a row's
temperature is <= 0, else a categorical draw from ``softmax(logits / T)``.

The draw is the Gumbel-max trick, as ``jax.random.categorical`` draws:
``argmax(logits / T + G)`` with ``G = -log(-log U)``, U uniform from an
explicit ``torch.Generator`` on the logits' device, so a whole batch is a
handful of device ops and no row is looked at on the host.  The two
packages draw different streams, so sampled tokens are held to the
softmax by their distribution, never token for token.
"""

from __future__ import annotations

import torch

#: the reference's temperature floor (``jnp.maximum(temps, 1e-6)``)
MIN_TEMPERATURE = 1e-6


def sample(logits: torch.Tensor, temps: torch.Tensor,
           generator: torch.Generator) -> torch.Tensor:
    """logits (B, V) fp32, temps (B,) on the same device -> int32 (B,)
    tokens: ``argmax`` where ``temps <= 0``, a draw from
    ``softmax(logits / max(T, 1e-6))`` elsewhere.  Every call draws B x V
    uniforms from ``generator``, whichever rows are greedy, so a seed
    fixes the stream of a run."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    scaled = logits.float() / temps.float().clamp_min(MIN_TEMPERATURE)[:, None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temps <= 0, logits.argmax(dim=-1),
                       sampled).to(torch.int32)


def softmax_tv_bound(probs: torch.Tensor, draws: int,
                     slack: float = 0.02) -> float:
    """A bound on the total-variation distance between ``probs`` (V,)
    and the empirical frequencies of ``draws`` independent draws from it:
    E[TV] <= 0.5 sum_i sqrt(p_i (1 - p_i) / n), and TV moves by at most
    1/n per draw, so it exceeds its mean by ``slack`` with probability at
    most exp(-2 n slack^2) (McDiarmid; 3e-4 at n = 10 000 and 0.02)."""
    p = probs.double()
    return float(0.5 * (p * (1 - p)).sqrt().sum() / draws ** 0.5) + slack
