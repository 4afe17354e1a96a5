"""Priority containers replicating the reference's sorted-set semantics.

The reference keeps matches/breaks in a Scala ``SortedSet`` whose *ordering
compares only the similarity* (FeatureCorrelation.scala:75-77 ``MatchMinOrd``,
FeatureSegmentation.scala:60-62 ``BreakMaxOrd``).  Two consequences are
observable in results and replicated here exactly:

* a tree set deduplicates by comparator equality, so a candidate whose sim
  equals an element already in the set is silently dropped, and removal
  removes *the* element with that sim;
* the comparator is ``java.lang.Float.compare`` — a total order where
  ``NaN`` sorts above ``+Inf`` (and equals itself) and ``-0.0 < 0.0``.  NaN
  sims (e.g. ``√(inSim·outSim)`` of a negative product,
  FeatureCorrelationImpl.scala:370) therefore rank as the *best* match.
  Loop gates, by contrast, use primitive IEEE comparisons where NaN is
  incomparable — callers must use raw ``sim`` floats for gates and this
  container only for ranking.
"""

from __future__ import annotations

import bisect
import math
import struct
from typing import Generic, Iterable, List, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

__all__ = ["SimSortedSet", "java_float_key", "replay_selection"]


def java_float_key(sim: float) -> int:
    """Total-order key equivalent to ``java.lang.Float.compare`` on the f32
    value: sign-adjusted IEEE-754 bits (all NaNs collapse to the canonical
    quiet NaN that JVM float arithmetic produces, so NaN == NaN > +Inf)."""
    u = struct.unpack(">I", struct.pack(">f", sim))[0]
    if (u & 0x7F800000) == 0x7F800000 and (u & 0x007FFFFF) != 0:
        u = 0x7FC00000  # canonical NaN (Float.floatToIntBits)
    # monotone unsigned key: positives shift up, negatives reverse
    return u + 0x80000000 if u < 0x80000000 else 0xFFFFFFFF - u


_key = java_float_key


class SimSortedSet(Generic[T]):
    """Bounded sorted set keyed by a float `sim`, mirroring Scala TreeSet.

    ``descending=True`` reproduces ``MatchMinOrd`` (best/highest sim at the
    head, ``last`` = lowest); ``descending=False`` reproduces ``BreakMaxOrd``
    (most dissimilar/lowest sim at the head, ``last`` = highest).
    """

    def __init__(self, descending: bool) -> None:
        self._descending = descending
        self._keys: List[int] = []   # ascending Float.compare keys
        self._items: dict = {}       # key -> item

    def __len__(self) -> int:
        return len(self._keys)

    def add(self, sim: float, item: T) -> None:
        """Insert unless an element with comparator-equal sim exists
        (TreeSet ``+=``)."""
        k = _key(sim)
        if k in self._items:
            return
        bisect.insort(self._keys, k)
        self._items[k] = item

    def remove_sim(self, sim: float) -> None:
        """Remove the element with this sim if present (TreeSet ``-=``)."""
        k = _key(sim)
        if k not in self._items:
            return
        idx = bisect.bisect_left(self._keys, k)
        del self._keys[idx]
        del self._items[k]

    # head = first in iteration order, last = the element truncation drops
    def _ordered(self) -> List[int]:
        return self._keys[::-1] if self._descending else self._keys

    @property
    def last(self) -> T:
        return self._items[self._ordered()[-1]]

    @property
    def last_sim(self) -> float:
        """Raw float sim of the last element — used by loop gates with
        primitive IEEE comparisons (may be NaN)."""
        return getattr(self.last, "sim")

    def drop_last(self) -> None:
        k = self._ordered()[-1]
        idx = bisect.bisect_left(self._keys, k)
        del self._keys[idx]
        del self._items[k]

    def truncate(self, n: int) -> None:
        """Keep the first ``n`` in iteration order (``allPrio.take(n)``)."""
        while len(self) > n:
            self.drop_last()

    def items(self) -> List[T]:
        return [self._items[k] for k in self._ordered()]

    def update(self, other: "SimSortedSet[T]") -> None:
        """``this ++= other`` (existing comparator-equal elements win)."""
        for k in other._ordered():
            item = other._items[k]
            if k not in self._items:
                bisect.insort(self._keys, k)
                self._items[k] = item


class _Candidate:
    """A match plus its punch-in-only sim — the latter drives the
    reference's ``inSim > low²`` scan gate (FeatureCorrelationImpl.scala:342)
    in :func:`replay_selection`."""

    __slots__ = ("match", "in_sim")

    def __init__(self, match, in_sim=None) -> None:
        self.match = match
        self.in_sim = in_sim

    @property
    def sim(self):
        return self.match.sim

    @property
    def punch(self):
        return self.match.punch


def replay_selection(per_file_candidates: Iterable[Sequence],
                     num_matches: int, num_per_file: int,
                     min_spacing: int, skip_nan: bool = False) -> List:
    """Exact replay of the reference's stateful match selection over
    externally produced candidates.

    Reproduces FeatureCorrelationImpl.scala's per-file entry queue and
    global merge (:113-150 ``addMatch``/``entryHasSpace``/``lowestSim``,
    :399-400 merge + truncate), offered the same way the reference offers
    windows: *per file, in ascending window order* — each element of
    ``per_file_candidates`` must already be sorted the way the reference's
    scan visits them (ascending punch-in offset, then punch length).
    Candidates need ``.sim`` (float) and ``.punch`` (:class:`Span`)
    attributes (e.g. :class:`~strugatzki_tpu_torch.config.Match`).

    The replay is exact over the candidates it is given; a caller feeding
    it a device top-k (the serving path) therefore equals the full
    ``FeatureCorrelation`` output whenever that top-k contains every
    candidate the reference's selection would have touched — raise the
    device ``k`` when ``num_matches·num_per_file`` (plus spacing-collapse
    churn) approaches it.
    """
    from ..span import spacing

    all_prio: SimSortedSet = SimSortedSet(descending=True)
    for cands in per_file_candidates:
        entry_prio: SimSortedSet = SimSortedSet(descending=True)
        last = None
        for m in cands:
            sim = m.sim
            if skip_nan and math.isnan(sim):
                continue
            has_space = len(entry_prio) < min(num_matches - len(all_prio),
                                              num_per_file)
            if len(entry_prio):
                low = entry_prio.last_sim
            elif len(all_prio):
                low = all_prio.last_sim
            else:
                low = 0.0
            # the punch-out combine's scan gate: a punch-in offset is only
            # visited at all when its in-sim alone beats low² (:342) —
            # applies regardless of queue space
            in_sim = getattr(m, "in_sim", None)
            # low² is a Java Float multiply (f32-rounded product, :342) —
            # gating on the unrounded f64 product could visit a different
            # offset set at rounding boundaries
            if in_sim is not None and not (in_sim > float(np.float32(low * low))):
                continue
            if not (has_space or sim > low):
                continue
            if last is not None and spacing(m.punch, last.punch) < min_spacing:
                # collapse against the most recent match only (:135-143)
                if last.sim < sim:
                    entry_prio.remove_sim(last.sim)
                    entry_prio.add(sim, m)
                    last = m
            else:
                entry_prio.add(sim, m)
                if len(entry_prio) > num_per_file:
                    entry_prio.drop_last()
                last = m
        all_prio.update(entry_prio)
        all_prio.truncate(num_matches)
    return all_prio.items()
