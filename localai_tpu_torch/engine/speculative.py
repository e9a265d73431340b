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

Two drafters, the JAX engine's. Prompt lookup (``ngram_propose``, the
default): the slot's trailing n-gram is matched against its own prompt +
emitted history, which is the sampler's penalty ring on the device
(engine/sampling.py: seeded with the prompt tail at admission, one entry
per emitted token), and the continuation after the most recent match is
proposed; no second model and no draft cache. A draft model
(``draft_propose``, when one is loaded): D + 1 greedy decode steps of a
smaller llama over its own KV cache, which ingests the current token and
every proposal, so a fully accepted round leaves no hole in it. Both
propose deterministically (the draft by argmax), so the draft law of the
sampled acceptance below is a one-hot either way.

Cache invariant: rows [0, length) hold the accepted context and the
CURRENT token (the last emitted) is not yet written; a round writes it
as its first row. Rows written for rejected proposals lie at or above
the new length: never committed, and overwritten by the next round.

SAMPLED ACCEPTANCE (temperature > 0, ``accept_sampled``): the target's
filtered window at every verify position (``sampling.verify_dist``) is
the law plain sampling draws from; proposal x_j is accepted with
probability p(x_j) (the proposals are deterministic, so the draft law is
a one-hot), the first rejection draws one token from p with x_j zeroed,
and full acceptance draws the bonus from p at the last position. The
emitted stream then has plain sampling's law exactly, though not its
bits: both draw from the counter RNG, but a round consumes D + 1 draws
where plain steps consume one per token. ``two_sample_chi2`` is the
test that holds two samples to one law.

Left for later slices: ``spec_round`` (the JAX package's standalone
round; the CPU tests compose the reference round from the JAX functions).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.engine.sampling import counter_uniform, draw_index
from localai_tpu_torch.models import llama


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


def draft_propose(dparams: dict, dcfg: llama.LlamaConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, dck: dict, dcv: dict,
                  active: torch.Tensor, n_draft: int) -> torch.Tensor:
    """Draft-model proposals (the JAX ``draft_propose``): D + 1 greedy
    decode steps of the draft over its own cache ``dck`` / ``dcv`` (any
    layout, written in place). tokens [S]: the current (not yet written)
    token per slot; lengths [S]: rows committed; active [S] bool: the rows
    that speculate. Step j writes its input token at row lengths + j and
    proposes the argmax after it, so the cache ingests the current token
    and all D proposals (the last step's pick is dropped): a fully
    accepted round leaves no hole in the draft's rows. Inactive rows
    write at the out-of-bounds row, so the scatter drops them, and their
    proposals are to be ignored. Returns proposals [S, D] in ``tokens``'
    dtype. Device ops only: no host data, no branch on a value."""
    tok = tokens
    dl = lengths.to(torch.int32)
    step = active.to(torch.int32)
    props = []
    for _ in range(n_draft + 1):
        logits = llama.decode_step(dparams, dcfg, tok, dl, dck, dcv,
                                   active=active)
        tok = torch.argmax(logits, dim=-1).to(tokens.dtype)
        props.append(tok)
        dl = dl + step
    return torch.stack(props[:n_draft], dim=1)


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


def accept_sampled(drafts: torch.Tensor, idx: torch.Tensor, probs: torch.Tensor,
                   active: torch.Tensor, seed: Optional[torch.Tensor] = None,
                   counter: Optional[torch.Tensor] = None,
                   uniforms: Optional[torch.Tensor] = None):
    """Rejection-sampled acceptance for sampled slots (the JAX
    ``accept_sampled`` with ``draft_probs=None``), in window space.

    drafts [S, D] proposals; idx / probs [S, D + 1, K] the filtered target
    window at every verify position (``sampling.verify_dist``; a token
    outside a row's window has p = 0, and ``idx = arange(V)`` with vocab
    probs is the vocabulary form); active [S] bool. The draws: ``uniforms``
    [S, D + 1] when given (D acceptance uniforms, then the categorical's),
    else ``counter_uniform(seed, counter + j)`` for j <= D from the rows'
    ``seed`` / ``counter`` [S].

    Proposal x_j is accepted when u_j < p_j(x_j); k = the accepted prefix.
    The final token is drawn by inverse CDF (``sampling.draw_index``, the
    sampler's rule) from p_k with x_k zeroed when k < D (the residual;
    when that is empty, from p_k itself), else from p_D (the bonus). The
    schedule is data-independent: every active row consumes D + 1 draws.
    Returns (out [S, D + 1] emitted tokens, zero past them; n_out [S] =
    k + 1 on an active row, 0 on another; k [S]; counter + (D + 1) on the
    active rows, the counter unchanged elsewhere, or None without one)."""
    S, D = drafts.shape
    dev = drafts.device
    if uniforms is None:
        j = torch.arange(D + 1, device=dev)
        uniforms = counter_uniform(seed[:, None], counter[:, None] + j[None, :])
    # p_j(x_j): the proposal's mass in its position's window (0 outside)
    hit = idx[:, :D] == drafts[:, :, None].to(idx.dtype)                 # [S, D, K]
    p_dr = (probs[:, :D] * hit).sum(dim=-1)                              # [S, D]
    accept = (uniforms[:, :D] < p_dr).to(torch.int64)
    k = torch.cumprod(accept, dim=1).sum(dim=1)                          # [S]
    row = torch.gather(probs, 1, k[:, None, None].expand(-1, 1, probs.shape[-1]))[:, 0]
    row_idx = torch.gather(idx, 1, k[:, None, None].expand(-1, 1, idx.shape[-1]))[:, 0]
    # on a rejection the proposal at k leaves the row (the residual)
    x_k = torch.gather(drafts, 1, k.clamp(max=D - 1)[:, None])[:, 0]
    resid = torch.where((k < D)[:, None] & (row_idx == x_k[:, None].to(row_idx.dtype)),
                        torch.zeros_like(row), row)
    fin = torch.where((resid > 0).any(dim=-1, keepdim=True), resid, row)
    choice = draw_index(fin, uniforms[:, D])
    final_tok = torch.gather(row_idx, 1, choice[:, None])[:, 0]
    pos = torch.arange(D + 1, device=dev)[None, :]
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    out = torch.where(pos < k[:, None], drafts_pad,
                      torch.where(pos == k[:, None], final_tok[:, None].to(drafts.dtype),
                                  torch.zeros_like(drafts_pad)))
    n_out = (k + 1) * active.to(torch.int64)
    new_counter = None
    if counter is not None:
        new_counter = counter + (D + 1) * active.to(counter.dtype)
    return out, n_out, k, new_counter


def two_sample_chi2(counts_a, counts_b, min_expected: float = 5.0):
    """Two-sample chi-square homogeneity test over per-category counts (the
    JAX ``two_sample_chi2``, host numpy). Categories whose combined count
    is below ``min_expected`` pool into one bin. Returns (stat, dof,
    p_value); p is uniform on [0, 1] when both samples draw from one law.
    The unequal-N form: sum (K1 a_i - K2 b_i)^2 / (a_i + b_i), K1 =
    sqrt(NB / NA), K2 = sqrt(NA / NB); p from ``scipy.stats.chi2``."""
    from scipy.stats import chi2

    a = np.asarray(counts_a, np.float64).ravel()
    b = np.asarray(counts_b, np.float64).ravel()
    big = (a + b) >= min_expected
    a = np.concatenate([a[big], [a[~big].sum()]])
    b = np.concatenate([b[big], [b[~big].sum()]])
    keep = (a + b) > 0
    a, b = a[keep], b[keep]
    if len(a) < 2 or a.sum() == 0 or b.sum() == 0:
        return 0.0, 0, 1.0
    k1 = np.sqrt(b.sum() / a.sum())
    k2 = np.sqrt(a.sum() / b.sum())
    stat = float(np.sum((k1 * a - k2 * b) ** 2 / (a + b)))
    dof = int(len(a) - 1)
    return stat, dof, float(chi2.sf(stat, dof))
