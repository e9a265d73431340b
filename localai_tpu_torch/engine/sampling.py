"""Batched token sampling over float32 logits (counterpart of
localai_tpu/engine/sampling.py, its whole surface).

Same design as the JAX sampler: the full vocabulary is touched once, by
the logit-bias add and a top-``SORT_K`` reduction to a candidate window,
and everything else acts on the window (``filter_window``): the repeat,
presence and frequency penalties over each slot's last ``repeat_last_n``
tokens (a per-slot RING of the last ``RING_N`` context tokens, prompt
tail included, as llama.cpp's penalty window), a re-sort, temperature,
the top-k / top-p / min-p keep-mask, typical-p, rank 0 always kept, and
mirostat v2's surprise cut. Greedy picks the re-sorted window's rank 0,
so penalties and bias change greedy tokens exactly as in JAX. Ties break
as the JAX stable ``argsort`` does: both re-sorts are stable.

Two variants, the JAX engine's two precompiled burst variants: plain
(``full=False``: bias, temperature, top-k / top-p / min-p) and full
(everything). The full variant on neutral parameters gives the plain
one's ids and logprobs bit for bit; ``feature_flags`` (over host mirrors
of the parameter vectors) says when the plain one suffices.

Randomness: a counter-based generator per slot, on the device (the JAX
sampler's per-slot ``rng_keys``). Each slot holds a ``seed`` (the request
seed, or a per-request fallback) and a ``counter`` of the draws it has
made; a draw is ``counter_uniform(seed, counter)``, a hash of the two in
integer torch ops only, so the CPU and the card give the same bits. The
counter advances only on a row that really drew (an active, non-greedy
row: the JAX engine's ``keys = where(active, new_keys, keys)``), so a
seeded stream does not depend on which path (prefill's first token or a
decode step, eager or a graph replay) drew each token, nor on the other
slots. A draw is one uniform per row, turned into a token by inverse CDF
over the filtered window on the device, so a decode burst never syncs
the host. The draws cannot replay JAX's threefry bits; sampled streams
match the reference in distribution only, greedy streams byte for byte.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from localai_tpu_torch.engine.transfer import to_device

SORT_K = 256  # candidate window (cap for top_k)
RING_N = 256  # penalty ring capacity (cap for repeat_last_n)
_LN2 = math.log(2.0)


@dataclasses.dataclass
class SamplingParamsHost:
    """Per-request sampling config (the JAX package's fields and
    defaults)."""
    temperature: float = 0.8
    top_k: int = 40          # 0 => disabled (the whole window)
    top_p: float = 0.95      # 1.0 => disabled
    min_p: float = 0.0
    typical_p: float = 1.0
    repeat_penalty: float = 1.0       # multiplicative (llama.cpp style)
    repeat_last_n: int = 64           # penalty window; < 0 => RING_N
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    mirostat: int = 0                 # 0 = off; 1 / 2 run the v2 sampler
    mirostat_tau: float = 5.0         # target surprise (bits)
    mirostat_eta: float = 0.1         # mu learning rate
    seed: int = -1           # < 0 => per-request fallback seed
    logit_bias: dict = dataclasses.field(default_factory=dict)  # token -> bias


# per-slot parameter vectors: name -> (dtype, neutral value)
PARAMS = {"temperature": (torch.float32, 1.0), "top_k": (torch.int64, 0),
          "top_p": (torch.float32, 1.0), "min_p": (torch.float32, 0.0),
          "typical_p": (torch.float32, 1.0),
          "repeat_penalty": (torch.float32, 1.0),
          "repeat_last_n": (torch.int64, 64),
          "presence_penalty": (torch.float32, 0.0),
          "frequency_penalty": (torch.float32, 0.0),
          "mirostat": (torch.int64, 0), "mirostat_tau": (torch.float32, 5.0),
          "mirostat_eta": (torch.float32, 0.1), "greedy": (torch.bool, True)}


def slot_values(p: SamplingParamsHost) -> dict:
    """One request's parameter vector entries, clamped as the JAX
    ``set_slot`` clamps them."""
    n = p.repeat_last_n if p.repeat_last_n is not None else 64
    return {
        "temperature": max(p.temperature, 1e-6),
        "top_k": p.top_k if 0 < p.top_k <= SORT_K else 0,
        "top_p": p.top_p if 0 < p.top_p <= 1.0 else 1.0,
        "min_p": min(max(p.min_p, 0.0), 1.0),
        "typical_p": p.typical_p if 0 < p.typical_p <= 1.0 else 1.0,
        "repeat_penalty": p.repeat_penalty or 1.0,
        # -1 = the whole context (llama.cpp), capped at the ring capacity
        "repeat_last_n": RING_N if n < 0 else min(n, RING_N),
        "presence_penalty": p.presence_penalty,
        "frequency_penalty": p.frequency_penalty,
        "mirostat": p.mirostat or 0,
        "mirostat_tau": p.mirostat_tau if p.mirostat_tau > 0 else 5.0,
        "mirostat_eta": p.mirostat_eta if p.mirostat_eta > 0 else 0.1,
        "greedy": p.temperature <= 0,
    }


def feature_flags(host: dict, active=None) -> dict:
    """Which sampler features any (active) slot uses, over host vectors
    (the JAX ``feature_flags``). Any of them selects the full variant."""
    sel = slice(None) if active is None else active
    pen = (np.any(host["repeat_penalty"][sel] != 1.0)
           or np.any(host["presence_penalty"][sel] != 0.0)
           or np.any(host["frequency_penalty"][sel] != 0.0))
    return {"use_penalties": bool(pen),
            "use_typical": bool(np.any(host["typical_p"][sel] < 1.0)),
            "use_mirostat": bool(np.any(host["mirostat"][sel] > 0))}


# ---------- penalty ring ----------

def set_slot_ring(ring: torch.Tensor, pos: torch.Tensor, slot: int, token_ids):
    """Seed a slot's ring with the tail of ``token_ids`` (its prompt, or a
    context shift's kept window), in place: ring [S, RING_N] (-1 = empty),
    pos [S] the monotone write cursor."""
    tail = [int(t) for t in token_ids][-RING_N:]
    row = np.full((RING_N,), -1, np.int64)
    row[:len(tail)] = tail
    to_device(ring[slot], row)
    pos[slot].fill_(len(tail))


def update_ring(ring: torch.Tensor, pos: torch.Tensor, ids: torch.Tensor,
                active: torch.Tensor):
    """Record ``ids`` [S] of the ``active`` [S] slots in their rings, in
    place (the JAX ``update_ring``)."""
    col = (pos % RING_N)[:, None]
    cur = torch.gather(ring, 1, col)[:, 0]
    ring.scatter_(1, col, torch.where(active, ids, cur)[:, None])
    pos.add_(active.to(pos.dtype))


def window_counts(ring, pos, idx, repeat_last_n):
    """Occurrences of each candidate ``idx`` [R, K] among each row's last
    ``repeat_last_n`` ring entries: ring [R, RING_N], pos [R] -> [R, K]."""
    rn = ring.shape[1]
    slot_off = torch.arange(rn, device=ring.device)[None, :]
    age = (pos[:, None] - 1 - slot_off) % rn
    # written entries only (the -1 fill) whose age is inside the window
    in_window = (age < repeat_last_n[:, None]) & (ring >= 0)
    match = ring[:, None, :] == idx[:, :, None]
    return (match & in_window[:, None, :]).sum(dim=-1)


def filter_window(logits: torch.Tensor, sp: dict, ring, ring_pos,
                  bias: torch.Tensor, mu=None, full: bool = True,
                  typical: Optional[bool] = None):
    """logits [R, V] f32, per-row parameter vectors ``sp`` [R] (names of
    ``PARAMS``), the rows' rings ring [R, RING_N] / ring_pos [R], bias
    [R, V] and mirostat's ``mu`` [R] -> (idx [R, K]
    candidate ids, masked [R, K] filtered log-probs (-inf outside the keep
    set, rank 0 always kept), vals [R, K] the post-penalty,
    pre-temperature window logits). ``full=False`` is the plain variant:
    no penalties, typical-p or mirostat (ring and mu unread).
    ``typical`` (default: ``full``) applies typical-p alone, as the JAX
    ``use_typical`` flag does (``verify_dist``)."""
    typical = full if typical is None else typical
    k = min(SORT_K, logits.shape[-1])
    top_vals, top_idx = torch.topk(logits + bias, k, dim=-1)  # sorted desc
    if full:
        cnt = window_counts(ring, ring_pos, top_idx, sp["repeat_last_n"])
        seen = cnt > 0
        rp = sp["repeat_penalty"][:, None]
        penalized = torch.where(top_vals > 0, top_vals / rp, top_vals * rp)
        vals = torch.where(seen, penalized, top_vals)
        vals = vals - seen * sp["presence_penalty"][:, None]
        vals = vals - cnt.to(torch.float32) * sp["frequency_penalty"][:, None]
        # penalties can reorder the window: re-sort descending, stably
        order = torch.argsort(-vals, dim=-1, stable=True)
        vals = torch.gather(vals, 1, order)
        idx = torch.gather(top_idx, 1, order)
    else:
        vals, idx = top_vals, top_idx
    scaled = vals / sp["temperature"][:, None]
    rank = torch.arange(k, device=logits.device)[None, :]
    top_k = sp["top_k"]
    k_s = torch.where(top_k > 0, top_k, torch.full_like(top_k, k))[:, None]
    keep = rank < k_s
    neg_inf = torch.full_like(scaled, float("-inf"))
    probs = torch.softmax(torch.where(keep, scaled, neg_inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < sp["top_p"][:, None])
    keep = keep & (probs >= sp["min_p"][:, None] * probs[:, :1])
    logp = torch.log(torch.clamp(probs, min=1e-20))
    if typical:
        # typical-p: the tokens whose -log p lies closest to the entropy,
        # until their mass reaches typical_p
        entropy = -torch.where(probs > 0, probs * logp,
                               torch.zeros_like(logp)).sum(-1, keepdim=True)
        deviation = torch.abs(-logp - entropy)
        dev_order = torch.argsort(deviation, dim=-1, stable=True)
        probs_by_dev = torch.gather(probs, 1, dev_order)
        cum_dev = torch.cumsum(probs_by_dev, dim=-1)
        keep_sorted = (cum_dev - probs_by_dev) < sp["typical_p"][:, None]
        inv = torch.argsort(dev_order, dim=-1, stable=True)
        keep_typical = torch.gather(keep_sorted, 1, inv)
        keep = torch.where(sp["typical_p"][:, None] < 1.0,
                           keep & keep_typical, keep)
    # the keep-masks may not intersect: the top candidate always stays
    keep = keep | (rank == 0)
    if full:
        # mirostat v2: the surprise-<=-mu cut over the whole window's
        # distribution replaces the keep chain
        miro_on = sp["mirostat"][:, None] > 0
        full_logp = torch.log_softmax(scaled, dim=-1)
        keep_miro = (-full_logp / _LN2 <= mu[:, None]) | (rank == 0)
        keep = torch.where(miro_on, keep_miro, keep)
        masked = torch.where(keep, torch.where(miro_on, full_logp, logp),
                             neg_inf)
    else:
        masked = torch.where(keep, logp, neg_inf)
    return idx, masked, vals


def verify_dist(logits: torch.Tensor, sp: dict, width: int,
                typical: bool = True):
    """The filtered target distribution at every speculative-verify
    position (the JAX ``verify_dist``): logits [S * W, V] from the verify
    forward (slot-major, ``width`` W positions per slot), ``sp`` the [S]
    parameter vectors, repeated over each slot's W positions. Returns
    (idx [S, W, K] candidate ids, probs [S, W, K] the softmax of
    ``filter_window``'s ``masked``: the law each position's plain draw
    takes). The same window code path as the decode step's sampler, so
    rejection acceptance against these probs keeps plain sampling's law.
    Penalties, mirostat and bias stay out (the spec purity gates keep
    slots that use them out of spec rounds); typical-p follows the
    sampler variant (``typical``). Greedy picks are ``idx[:, :, 0]``."""
    W = width
    rep = {name: t.repeat_interleave(W) for name, t in sp.items()}
    zero_bias = torch.zeros((1, 1), dtype=logits.dtype, device=logits.device)
    idx, masked, _vals = filter_window(logits, rep, None, None, zero_bias,
                                       full=False, typical=typical)
    probs = torch.softmax(masked, dim=-1)
    S = logits.shape[0] // W
    return idx.reshape(S, W, -1), probs.reshape(S, W, -1)


def draw_index(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of one index per row from non-negative ``weights``
    [R, K] (not necessarily normalized) with uniforms ``u`` [R]: the first
    index whose cumulative weight reaches ``u`` x the row's total (the
    rule of ``SlotSampler._draw``; a leading zero-weight entry is never
    drawn, even at u = 0)."""
    cdf = torch.cumsum(weights, dim=-1)
    below = (cdf < u[:, None] * cdf[:, -1:]) | (cdf <= 0)
    return below.sum(dim=-1).clamp(max=weights.shape[-1] - 1)


def mirostat_mu(mu, masked, choice, sp):
    """mu after drawing window rank ``choice`` [R] from ``masked`` (the JAX
    ``sample``'s update: mu -= eta * (observed surprise - tau)), for the
    rows with mirostat on and not greedy; the others keep theirs."""
    lp = torch.gather(torch.log_softmax(masked, dim=-1), 1, choice[:, None])[:, 0]
    new = mu - sp["mirostat_eta"] * (-lp / _LN2 - sp["mirostat_tau"])
    return torch.where((sp["mirostat"] > 0) & ~sp["greedy"], new, mu)


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1          # odd: counter -> counter * _GOLDEN is a bijection


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32) and a 32-bit constant c,
    in two 16-bit halves of c so that no product reaches 2**63 (int64
    overflow is not relied on)."""
    lo = h * (c & 0xFFFF)                                 # < 2**48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16                 # < 2**32
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection of [0, 2**32))."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_uniform(seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """The counter RNG's draw: int64 ``seed`` and ``counter`` (any shape,
    each taken mod 2**32) -> float32 uniforms in [0, 1) with 24 random
    bits, ``fmix32(fmix32(seed) ^ (counter * GOLDEN mod 2**32)) >> 8``
    over 2**24. Integer ops only: the same bits on every device."""
    key = _fmix32(seed & _M32)
    h = _fmix32(key ^ _mul32(counter & _M32, _GOLDEN))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class SlotSampler:
    """Per-slot sampling state on one device, every tensor written in
    place (captured graphs read it where it lies): the parameter vectors
    ``p`` (``PARAMS``, [S] each) and their host mirrors ``host`` (numpy,
    for ``feature_flags``), the penalty ring ``ring`` [S, RING_N] (-1 =
    empty) and ``ring_pos`` [S], the logit bias ``bias`` [S, V] (zero
    until a request sets its row), mirostat's ``mu`` [S] and the counter
    RNG's ``seed`` / ``counter`` [S]. A grammar's rows (its request's
    logit bias plus the state's mask penalty) are written whole by
    ``write_bias_rows``."""

    def __init__(self, num_slots: int, vocab_size: int, device):
        self.device = torch.device(device)
        S, dev = num_slots, self.device
        self.p = {name: torch.full((S,), v, dtype=dt, device=dev)
                  for name, (dt, v) in PARAMS.items()}
        self.host = {name: self.p[name].cpu().numpy().copy() for name in PARAMS}
        self.ring = torch.full((S, RING_N), -1, dtype=torch.int64, device=dev)
        self.ring_pos = torch.zeros(S, dtype=torch.int64, device=dev)
        self.bias = torch.zeros((S, vocab_size), dtype=torch.float32, device=dev)
        self._bias_dirty = [False] * S
        self.mu = torch.full((S,), 10.0, dtype=torch.float32, device=dev)
        self.seed = torch.zeros(S, dtype=torch.int64, device=dev)
        self.counter = torch.zeros(S, dtype=torch.int64, device=dev)
        self._slots = torch.arange(S, device=dev)

    def set_slot(self, slot: int, p: SamplingParamsHost, fallback_seed: int,
                 grammar_row: Optional[tuple] = None):
        """Install one request's parameters, its bias row (or clear the row
        a previous request set: the JAX ``_bias_dirty``; a grammar
        request's ``grammar_row`` = (logit bias row, first mask penalty)
        goes in whole through ``write_bias_rows``), mu = 2 * tau,
        seed its generator and reset its counter. The ring is seeded
        apart (``set_ring``). Every write is a device op in stream order,
        none waits for the card (``fill_`` takes the value as a kernel
        argument, where ``t[slot] = v`` would copy it in and wait): it
        lands after the bursts the slot's previous request still rides."""
        for name, v in slot_values(p).items():
            self.host[name][slot] = v
            self.p[name][slot].fill_(v)
        self.mu[slot].fill_(2.0 * (p.mirostat_tau if p.mirostat_tau > 0 else 5.0))
        if grammar_row is not None:
            self.write_bias_rows([slot], [grammar_row])
        elif p.logit_bias:
            row = np.zeros((self.bias.shape[1],), np.float32)
            for tok, b in p.logit_bias.items():
                if 0 <= int(tok) < row.shape[0]:
                    row[int(tok)] = float(b)
            to_device(self.bias[slot], row)
            self._bias_dirty[slot] = True
        elif self._bias_dirty[slot]:
            self.bias[slot].zero_()
            self._bias_dirty[slot] = False
        seed = p.seed if p.seed is not None and p.seed >= 0 else fallback_seed
        self.seed[slot].fill_(int(seed) & _M32)
        self.counter[slot].zero_()

    def write_bias_rows(self, slots: Sequence[int], rows: Sequence[tuple]):
        """Write whole bias rows, ``rows[j]`` = (base, penalty) host f32 [V]
        arrays summed into slot ``slots[j]``'s row (the JAX engine's
        ``_flush_grammar_bias`` scatter): one copy of the stacked rows and
        one indexed copy, in stream order and without waiting for the card,
        so bursts already dispatched read the rows they found. On CUDA the
        sums go into pinned memory from PyTorch's caching host allocator,
        which reuses a block only once the copies recorded on it have run
        (engine/ab_bias_flush.py times this against a ring of its own)."""
        for slot in slots:
            self._bias_dirty[slot] = True
        cuda = self.bias.is_cuda
        src = torch.empty((len(slots), self.bias.shape[1]), dtype=torch.float32,
                          pin_memory=cuda)
        host = src.numpy()
        for j, (base, pen) in enumerate(rows):
            np.add(base, pen, out=host[j])
        idx = torch.tensor(list(slots), dtype=torch.int64)
        if cuda:
            src = src.to(self.device, non_blocking=True)
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        self.bias.index_copy_(0, idx, src)

    def set_ring(self, slot: int, token_ids):
        """Seed (or, at a context shift, restart) a slot's penalty ring
        from the tail of ``token_ids``."""
        set_slot_ring(self.ring, self.ring_pos, slot, token_ids)

    def full_needed(self, active) -> bool:
        """Whether any ``active`` slot (a host bool mask) needs the full
        variant."""
        return any(feature_flags(self.host, active).values())

    def _draw(self, logits, sp, ring, ring_pos, bias, mu, seed, counter,
              full: bool):
        """One token per row from the rows' state, branch-free: (ids [R]
        int64, logprobs [R] f32, mu after the draw [R])."""
        idx, masked, vals = filter_window(logits, sp, ring, ring_pos, bias,
                                          mu=mu, full=full)
        choice = draw_index(torch.softmax(masked, dim=-1),
                            counter_uniform(seed, counter))
        rank = torch.where(sp["greedy"], torch.zeros_like(choice), choice)
        ids = torch.gather(idx, 1, rank[:, None])[:, 0]
        # the logprob under the post-penalty, pre-temperature window
        lps = torch.gather(torch.log_softmax(vals, dim=-1), 1, rank[:, None])[:, 0]
        new_mu = mirostat_mu(mu, masked, choice, sp) if full else mu
        return ids, lps, new_mu

    def sample_all(self, logits: torch.Tensor, active: torch.Tensor,
                   full: bool = False):
        """The decode step's sampler (the JAX ``_make_scan_step``): row s of
        ``logits`` [S, V] is slot s, ``active`` [S] bool (on the device)
        marks the rows that draw. An active slot's token enters its ring,
        its mu moves (full variant) and its counter advances (non-greedy).
        Builds nothing from the host and never branches on a value, so a
        CUDA graph can hold it. Returns (ids [S] int64, logprobs [S] f32)."""
        ids, lps, new_mu = self._draw(
            logits, self.p, self.ring, self.ring_pos, self.bias, self.mu,
            self.seed, self.counter, full)
        update_ring(self.ring, self.ring_pos, ids, active)
        if full:
            self.mu.copy_(torch.where(active, new_mu, self.mu))
        self.counter.add_((active & ~self.p["greedy"]).to(torch.int64))
        return ids, lps

    def sample_rows(self, logits: torch.Tensor, seg_slots: torch.Tensor,
                    final_mask: torch.Tensor, full: bool = True):
        """The packed prefill's first-token sampler: row r of ``logits``
        [R, V] is segment r of a pack, ``seg_slots`` [R] int (on the
        device) its slot, the sentinel S for a pad segment, and
        ``final_mask`` [R] bool the rows whose token is used. Every row
        draws with its slot's parameters, ring, bias, mu and counter (a
        pad row reads a clamped slot); only a final row writes its slot's
        state back: its token enters the ring, mu moves (mirostat,
        non-greedy rows) and the counter advances (non-greedy rows); a pad
        or non-final row writes nothing (the JAX engine's
        ``.at[seg_slots].set(where(final_mask, new, old), mode="drop")``;
        slots are unique within a pack). Builds nothing from the host and
        never branches on a value, so a CUDA graph can hold it. Returns
        (ids [R] int64, logprobs [R] f32)."""
        S = self.counter.shape[0]
        sel = seg_slots.to(torch.int64).clamp(0, S - 1)
        sp = {name: t[sel] for name, t in self.p.items()}
        ids, lps, new_mu = self._draw(
            logits, sp, self.ring[sel], self.ring_pos[sel], self.bias[sel],
            self.mu[sel], self.seed[sel], self.counter[sel], full)
        # rows -> slots through a one-hot (at most one row per slot), so a
        # pad row's clamped slot is never written
        hit = (seg_slots.to(torch.int64)[:, None] == self._slots[None, :]) \
            & final_mask[:, None]                                   # [R, S]
        fin = hit.any(dim=0)
        update_ring(self.ring, self.ring_pos, (hit * ids[:, None]).sum(dim=0), fin)
        self.mu.copy_(torch.where(fin, (hit * new_mu[:, None]).sum(dim=0), self.mu))
        self.counter.add_((hit & ~sp["greedy"][:, None]).sum(dim=0))
        return ids, lps

    def sample(self, logits: torch.Tensor, slots: Sequence[int],
               draw: Optional[Sequence[bool]] = None, full: bool = True):
        """Sample one token per row; row r uses slot ``slots[r]``'s state
        (index tensors built from the host lists, outside any graph: the
        eager reference loops of engine/decode_graph.py and
        engine/prefill_graph.py). ``draw[r]`` False marks rows whose result
        is discarded (inactive slots): they write no state. Returns (ids
        [R] int64, logprobs [R] f32), on the device, without a host
        sync."""
        sel = torch.as_tensor(list(slots), dtype=torch.int64, device=self.device)
        drawing = torch.as_tensor(
            [True] * len(sel) if draw is None else list(draw),
            dtype=torch.bool, device=self.device)
        return self.sample_rows(logits, sel, drawing, full=full)
