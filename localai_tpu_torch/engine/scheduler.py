"""Priority-aware preemptive scheduler (a copy of
localai_tpu/engine/scheduler.py; the port imports nothing of the JAX
package, so it keeps its own).

This module owns the per-tick run decision of the engine
(engine/engine.py):

  * every request carries a ``priority`` class (``high`` / ``normal`` /
    ``low``), set per request (the OpenAI body's ``priority``) or as a
    model default (``EngineConfig.priority``);
  * each class gets a weighted fair share of the packed-prefill token
    budget via deficit round-robin — a burst of one class cannot
    monopolize a tick, but unused budget rolls to whoever has work;
  * under pool pressure or a higher-priority arrival the engine PREEMPTS
    an active victim slot: the slot pauses at a burst boundary, its
    committed pages stay retained in the prefix cache (and offload to the
    host tier under pressure through the normal reclaim path), and the
    request parks in a resume queue until capacity returns.  Resume is
    plain re-admission — the chained-hash splice (device or host tier)
    restores the KV, and a lost host entry degrades to a re-prefill of
    the identical token history (the continuation is conditioned exactly
    as a fresh submission of that history would be);
  * a starvation guard bounds how often one request may be preempted
    (``max_preemptions``) and ages long-queued work up one effective
    class so ``low`` traffic cannot wait forever behind a ``high`` flood.

The scheduler holds no engine state beyond bookkeeping: pausing, paging
and re-admission stay in `engine.py`; this module only decides *who* runs.
The functions and the class are the JAX module's, line for line; only the
annotation of ``ResumeEntry.mu`` differs (the port keeps the mirostat
state as a device tensor, so parking a slot never waits for the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Priority classes, highest first.  Rank is the index: lower rank wins.
PRIORITY_CLASSES: Tuple[str, ...] = ("high", "normal", "low")
PRIORITY_RANK: Dict[str, int] = {c: i for i, c in enumerate(PRIORITY_CLASSES)}
DEFAULT_PRIORITY = "normal"
DEFAULT_WEIGHTS = "4:2:1"


def normalize_priority(value: Any, default: str = DEFAULT_PRIORITY) -> str:
    """Map arbitrary wire input to a known class; unknown -> default."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in PRIORITY_RANK:
            return v
    return default


def parse_priority_weights(spec: str) -> Tuple[int, ...]:
    """Parse ``high:normal:low`` colon-separated integer weights.

    Option values ride a comma-joined wire, hence colons.  Raises
    ``ValueError`` on anything that is not exactly three positive ints.
    """
    parts = [p.strip() for p in str(spec).split(":")]
    if len(parts) != len(PRIORITY_CLASSES):
        raise ValueError(
            f"priority_weights needs {len(PRIORITY_CLASSES)} colon-separated "
            f"integers (high:normal:low), got {spec!r}"
        )
    try:
        weights = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"priority_weights must be integers, got {spec!r}")
    if any(w <= 0 for w in weights):
        raise ValueError(f"priority_weights must be positive, got {spec!r}")
    return weights


@dataclass
class ResumeEntry:
    """A preempted request parked until capacity returns.

    Carries everything the engine needs to re-admit the request as a
    continuation: the full token history (prompt + committed generated
    tokens), the streaming detokenizer state, and the accounting that
    must survive the pause (first-token time, decoded counts, mirostat
    state, preemption count).
    """

    req: Any
    ids: List[int]  # prompt + generated tokens processed so far
    priority: str = DEFAULT_PRIORITY
    generated: List[int] = field(default_factory=list)
    n_decoded: int = 0
    prompt_len: int = 0
    detok: Any = None
    held_text: str = ""
    t_start: float = 0.0
    t_first_token: Optional[float] = None
    t_prefill_ms: float = 0.0
    mu: Optional[Any] = None   # the slot's mirostat state (a 0-d tensor)
    preempt_count: int = 1
    t_parked: float = field(default_factory=time.monotonic)
    # the engine's paused slot snapshot (its emitter grafts the stream's
    # text state from it at resume); None where nothing needs it
    snap: Any = None


class Scheduler:
    """Deficit-round-robin priority scheduler with a resume queue.

    Engine contract per tick:
      1. ``begin_tick(budget)`` refreshes the per-class prefill deficits.
      2. ``take(cls, want)`` caps how many prompt tokens a slot of class
         ``cls`` may pack this tick (charged via the return value).
      3. ``pick_queued(snapshot)`` orders queued work for admission.
      4. ``pick_victim(active)`` chooses a preemption victim when a
         higher-priority request cannot be admitted.
      5. ``park``/``pop_resume`` manage paused requests.
    """

    def __init__(
        self,
        weights: Tuple[int, ...] = parse_priority_weights(DEFAULT_WEIGHTS),
        max_preemptions: int = 2,
        aging_ms: float = 4000.0,
    ):
        self.weights = tuple(weights)
        self.max_preemptions = int(max_preemptions)
        self.aging_ms = float(aging_ms)
        # DRR deficit counters, one per class, in prompt tokens.
        self._deficit = [0] * len(PRIORITY_CLASSES)
        self._resume: List[ResumeEntry] = []
        # counters (exported via engine metrics())
        self.preemptions = 0
        self.adoptions = 0      # entries adopted from another engine
        self.resumes = 0
        self.resume_reprefills = 0
        self.resume_restore_rows = 0
        self.aged_promotions = 0

    # ---- class helpers -------------------------------------------------

    def effective_rank(self, priority: str, waited_s: float) -> int:
        """Rank after aging: long-queued work is promoted one class."""
        rank = PRIORITY_RANK.get(priority, PRIORITY_RANK[DEFAULT_PRIORITY])
        if rank > 0 and self.aging_ms > 0 and waited_s * 1000.0 >= self.aging_ms:
            rank -= 1
        return rank

    # ---- deficit round-robin over the prefill token budget -------------

    def begin_tick(self, budget: int, pending_by_class: List[int]) -> None:
        """Refresh deficits for one packed-prefill walk.

        Each class with pending prompt tokens earns its weighted share of
        ``budget``; classes with no work forfeit their share to the ones
        that have some (work-conserving).  Deficits carry over so a class
        shortchanged by granularity (chunk boundaries) catches up on the
        next tick, but are clamped to one budget so an idle class cannot
        bank unbounded credit.
        """
        active = [i for i, n in enumerate(pending_by_class) if n > 0]
        if not active:
            return
        wsum = sum(self.weights[i] for i in active)
        for i in range(len(PRIORITY_CLASSES)):
            if i in active:
                share = budget * self.weights[i] // max(1, wsum)
                self._deficit[i] = min(self._deficit[i] + share, 2 * budget)
            else:
                self._deficit[i] = 0

    def take(self, rank: int, want: int, slack: int = 0) -> int:
        """Grant up to ``want`` prompt tokens against class ``rank``'s deficit.

        ``slack`` is budget no other class can use this tick (their queues
        are empty); it is granted beyond the deficit so the walk stays
        work-conserving.
        """
        if want <= 0:
            return 0
        grant = min(want, self._deficit[rank] + max(0, slack))
        used_deficit = min(grant, self._deficit[rank])
        self._deficit[rank] -= used_deficit
        return grant

    def deficit(self, rank: int) -> int:
        return self._deficit[rank]

    def burst_share(self, dec_rank: Optional[int],
                    pending_by_class: List[int], cap: int) -> int:
        """Weighted decode-burst budget (without it the DRR weights
        would shape prefill admission only, so a saturating low-class
        decode fleet would hold full bursts while high-class prompts
        queued a whole burst behind each tick).

        When prompt work of a class STRICTLY higher-priority than every
        decoding slot is pending, shrink the burst to the decoding
        class's weighted share so the loop returns to admission sooner.
        Neutral (returns ``cap``) whenever nothing higher is waiting —
        single-class traffic and ``preempt=0`` (no scheduler at all)
        keep today's sizing bit-for-bit."""
        if dec_rank is None or cap <= 1:
            return cap
        best = None
        for r, n in enumerate(pending_by_class):
            if n > 0:
                best = r
                break
        if best is None or best >= dec_rank:
            return cap
        w = self.weights
        return max(1, cap * w[dec_rank] // max(1, w[dec_rank] + w[best]))

    # ---- queue ordering ------------------------------------------------

    def order_queued(self, entries: List[Tuple[str, float, Any]]) -> List[Any]:
        """Order queued items for admission.

        ``entries`` is ``[(priority, enqueue_monotonic, item), ...]``.
        Sort by aged effective rank, then arrival (stable FIFO within a
        class).  Returns the items, best first.
        """
        now = time.monotonic()
        ranked = []
        for pr, t_enq, item in entries:
            base = PRIORITY_RANK.get(pr, PRIORITY_RANK[DEFAULT_PRIORITY])
            rank = self.effective_rank(pr, now - t_enq)
            if rank < base:
                self.aged_promotions += 1
            ranked.append((rank, t_enq, item))
        ranked.sort(key=lambda e: (e[0], e[1]))
        return [item for _, _, item in ranked]

    # ---- shedding ------------------------------------------------------

    def pick_shed_victim(
        self, newcomer_rank: int, queued: List[Tuple[str, float, Any]]
    ) -> Optional[Any]:
        """Queue-wait-aware shedding: longest-queued of the lowest class.

        Only returns a victim whose class is STRICTLY lower than the
        newcomer's — same-class pressure still sheds the newcomer (keeps
        the admission-control contract: a full queue of equals refuses
        the arrival).
        """
        worst = None
        worst_key = None
        for pr, t_enq, item in queued:
            rank = PRIORITY_RANK.get(pr, PRIORITY_RANK[DEFAULT_PRIORITY])
            if rank <= newcomer_rank:
                continue
            key = (rank, -t_enq)  # lowest class first, then longest-queued
            if worst_key is None or key > worst_key:
                worst_key = key
                worst = item
        return worst

    # ---- preemption ----------------------------------------------------

    def pick_victim(
        self, incoming_rank: int, active: List[Tuple[int, str, float, int]]
    ) -> Optional[int]:
        """Choose a slot to preempt for an incoming request of ``incoming_rank``.

        ``active`` is ``[(slot, priority, t_start, preempt_count), ...]``
        for slots the engine deems pausable.  Picks the lowest class
        strictly below the incoming rank, newest start first (oldest work
        has sunk the most cost), skipping slots already preempted
        ``max_preemptions`` times.  Returns the slot or None.
        """
        best = None
        best_key = None
        for slot, pr, t_start, n_pre in active:
            rank = PRIORITY_RANK.get(pr, PRIORITY_RANK[DEFAULT_PRIORITY])
            if rank <= incoming_rank:
                continue
            if n_pre >= self.max_preemptions:
                continue
            key = (rank, t_start)  # lowest class, then most recent start
            if best_key is None or key > best_key:
                best_key = key
                best = slot
        return best

    # ---- resume queue --------------------------------------------------

    def park(self, entry: ResumeEntry) -> None:
        self.preemptions += 1
        self._resume.append(entry)

    def adopt(self, entry: ResumeEntry) -> None:
        """Park a resume entry MIGRATED from a sibling replica —
        identical to ``park`` except the preemption happened (and
        was counted) on the source engine, so this one's counter must
        not move. List append is atomic under the GIL, so the pool may
        call this from its own thread while the engine loop pops."""
        self.adoptions += 1
        self._resume.append(entry)

    def remove_parked(self, request_id: str) -> Optional[ResumeEntry]:
        """Pop the parked entry for ``request_id`` (migration-out of a
        request that was paused, not active), or None."""
        for i, e in enumerate(self._resume):
            if getattr(e.req, "request_id", None) == request_id:
                return self._resume.pop(i)
        return None

    def drain_parked(self) -> List[ResumeEntry]:
        """Remove and return ALL parked entries (replica died: siblings
        adopt its whole resume queue)."""
        out, self._resume = self._resume, []
        return out

    def _best_resume_index(self) -> int:
        now = time.monotonic()
        best_i = 0
        best_key = None
        for i, e in enumerate(self._resume):
            key = (self.effective_rank(e.priority, now - e.t_parked), e.t_parked)
            if best_key is None or key < best_key:
                best_key = key
                best_i = i
        return best_i

    def peek_resume(self) -> Optional[ResumeEntry]:
        """Best parked request (aged rank, oldest park first), not removed."""
        if not self._resume:
            return None
        return self._resume[self._best_resume_index()]

    def pop_resume(self) -> Optional[ResumeEntry]:
        """Next parked request to restore: best aged rank, oldest park first."""
        if not self._resume:
            return None
        return self._resume.pop(self._best_resume_index())

    def requeue_front(self, entry: ResumeEntry) -> None:
        """Put a resume entry back (admission failed); keeps its park time."""
        self._resume.insert(0, entry)

    @property
    def resume_depth(self) -> int:
        return len(self._resume)

    def resume_priorities(self) -> List[str]:
        return [e.priority for e in self._resume]

    def stats(self) -> Dict[str, Any]:
        return {
            "preemptions": self.preemptions,
            "adoptions": self.adoptions,
            "resumes": self.resumes,
            "resume_reprefills": self.resume_reprefills,
            "resume_restore_rows": self.resume_restore_rows,
            "aged_promotions": self.aged_promotions,
            "resume_depth": len(self._resume),
            "weights": dict(zip(PRIORITY_CLASSES, self.weights)),
        }
