"""Speculative decoding, n-gram self-speculation with greedy acceptance
(counterpart of localai_tpu/engine/speculative.py).

One ROUND proposes D tokens per slot cheaply, then the target model
scores the current token and the D proposals, W = D + 1 positions, in
ONE continued ragged prefill with logits at every position, and keeps
the longest prefix of proposals that match its own greedy picks plus
the target's pick after it (the bonus). Greedy speculation is LOSSLESS:
the emitted stream is the target's plain greedy stream whatever the
drafter proposed; a rejected proposal only wastes the round's spare
work. The round itself lives beside the decode step
(engine/decode_graph.py::DecodeGraph.spec_body).

The drafter here is prompt lookup (``ngram_propose``): the slot's
trailing n-gram is matched against its own prompt + emitted history,
which is the sampler's penalty ring on the device (engine/sampling.py:
seeded with the prompt tail at admission, one entry per emitted token),
and the continuation after the most recent match is proposed. No second
model and no draft cache, so every eligible request can speculate.

Cache invariant: rows [0, length) hold the accepted context and the
CURRENT token (the last emitted) is not yet written; a round writes it
as its first row. Rows written for rejected proposals lie at or above
the new length: never committed, and overwritten by the next round.

Left for later slices: ``draft_propose`` (the draft model's proposals),
``accept_sampled`` and ``two_sample_chi2`` (rejection-sampled acceptance
for temperature > 0, with ``sampling.verify_dist``), and ``spec_round``
(its n-gram analogue is what the CPU tests compose from the JAX
functions as the reference).
"""

from __future__ import annotations

import torch


def ngram_propose(tokens: torch.Tensor, ring: torch.Tensor,
                  ring_pos: torch.Tensor, n_draft: int, ngram: int
                  ) -> torch.Tensor:
    """Prompt-lookup proposals from each slot's own token history.

    tokens [S]: the current (not yet written) token per slot; ring
    [S, N] / ring_pos [S]: the penalty ring (-1 = an unwritten seed
    entry) and its monotone write cursor. Returns proposals [S, D] in
    ``tokens``' dtype.

    The trailing ``ngram``-gram of the chronological history (the current
    token last) is compared with every aligned window before it; the
    continuation after the MOST RECENT match is proposed, clipped at the
    newest entry. Windows holding a -1 never match, and a trailing gram
    holding one matches nothing. No match proposes the current token D
    times, which the verify rejects (lossless either way). Device ops
    only: no host data, no branch on a value."""
    S, N = ring.shape
    D, G = n_draft, ngram
    dev = ring.device
    ar = torch.arange(N, device=dev)
    # chronological view, oldest -> newest: the ring writes at pos % N and
    # then advances, so entry (pos + j) % N ages left to right
    idx = (ring_pos.to(torch.int64)[:, None] + ar[None, :]) % N
    hist = torch.gather(ring, 1, idx)                               # [S, N]
    trail = hist[:, N - G:]                                         # [S, G]
    starts = torch.arange(N - G, device=dev)                        # [P]
    win = starts[:, None] + torch.arange(G, device=dev)[None, :]    # [P, G]
    wins = hist[:, win]                                             # [S, P, G]
    ok = (wins == trail[:, None, :]).all(dim=-1)
    ok = ok & (wins >= 0).all(dim=-1)
    ok = ok & (trail >= 0).all(dim=-1)[:, None]
    best = torch.where(ok, starts[None, :], torch.full_like(ok, -1, dtype=torch.int64)
                       ).max(dim=1).values                          # [S]
    has = best >= 0
    cont = torch.clamp(best[:, None] + G + torch.arange(D, device=dev)[None, :],
                       max=N - 1)
    props = torch.gather(hist, 1, cont)                             # [S, D]
    return torch.where(has[:, None], props, tokens[:, None].to(props.dtype)
                       ).to(tokens.dtype)


def accept_greedy(drafts: torch.Tensor, greedy: torch.Tensor,
                  active: torch.Tensor):
    """Greedy acceptance: the longest matched prefix plus the target's
    bonus. drafts [S, D] proposals, greedy [S, D + 1] the target's greedy
    pick at every verify position, active [S] bool. Returns (out [S, D + 1]
    the emitted tokens, zero past them; n_out [S] their count = matched
    prefix + 1 on an active row, 0 on another; k [S] the accepted
    proposals)."""
    S, D = drafts.shape
    match = (drafts == greedy[:, :D]).to(torch.int64)
    k = torch.cumprod(match, dim=1).sum(dim=1)                      # [S]
    bonus = torch.gather(greedy, 1, k[:, None])[:, 0]
    pos = torch.arange(D + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    zero = torch.zeros_like(drafts_pad)
    out = torch.where(pos < k[:, None], drafts_pad,
                      torch.where(pos == k[:, None], bonus[:, None].to(drafts.dtype),
                                  zero))
    n_out = (k + 1) * active.to(torch.int64)
    return out, n_out, k
