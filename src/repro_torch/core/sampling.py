"""Sub-linear cohort sampling for million-client populations (the port's
own copy of ``repro.core.sampling``, DESIGN.md §12; numpy only).

The Gumbel-top-k sampler of :meth:`ClientSchedule.sample_cohort` is exact
but O(n) a round: n availability weights, n Gumbel variates and a top-s
over the population.  ``sampler="tree"`` replaces it with a host-side
**segment tree** over the churn gate with rejection on the diurnal factor:

* O(s log n) per weighted without-replacement draw;
* O(churn * log n) incremental gate updates a round: only the clients
  whose churn gate flips touch the tree, found by an arc search over the
  once-sorted staggers, never a population scan;
* no O(n) work on the device: the round receives the ``(s,)`` cohort.

The availability weight factors as ``w_i(t) = gate_i(t) * diurnal_i(t)``
with ``gate`` in {0, 1} and ``diurnal`` in [1-amp, 1].  The tree holds the
gate as an envelope; a draw proposes a gated client uniformly (tree
descent) and accepts it with probability ``diurnal_i(t)``, which draws
proportionally to ``w_i(t)`` among the remaining clients, without
replacement (accepted leaves are zeroed and restored after the cohort).
When fewer than ``s`` clients are online the cohort is padded with the
lowest-indexed offline clients, as the Gumbel path breaks its
-inf ties; the returned ``online`` mask flags them.

Draws are deterministic functions of ``(key words, round, s)`` (the RNG
is seeded from the raw uint32 key words and the round index through
``SeedSequence`` + ``Philox``) and memoised, so the engine's cohort
planner (which feeds the prefetching store) and the round share one
draw.  Every formula is the reference's, in the same numpy float32 and
float64 operations, so the cohorts are the reference's bit for bit.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

#: proposals per draw before falling back to the exact O(n) path — only
#: reachable when almost every gated client sits at a deep diurnal trough
_REJECTION_CAP_PER_PICK = 64
#: memoised (key, t, s) -> cohort entries kept for the planner/round pair
_CACHE_SIZE = 4096


def _host_f32(values) -> np.ndarray:
    """A ``(n,)`` tensor or array as a float32 numpy array on the host."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values, np.float32)


class TreeSampler:
    """Segment-tree weighted without-replacement cohort sampler.

    One instance per :class:`~repro_torch.core.clients.ClientAvailability`;
    all state is host-side numpy.  ``draw`` is thread-safe (the cohort
    planner and the round may race on the memo cache).
    """

    def __init__(self, availability):
        self.avail = availability
        n = availability.n_clients
        self.n = n
        self.phase = _host_f32(availability.phase)
        self.stagger = _host_f32(availability.stagger)
        self.period = float(availability.period)
        self.amp = float(availability.amp)
        self.churn_rate = float(availability.churn_rate)
        self.online_frac = float(availability.online_frac)
        self.gated = (self.churn_rate > 0.0 and self.online_frac < 1.0)
        # implicit segment tree over the gate indicator: leaves are 0/1 so
        # every internal node is an exact integer-valued double (counts,
        # no float drift) and a descent never mis-routes
        self._m = 1 << max(1, (n - 1).bit_length())
        self._tree = np.zeros(2 * self._m, np.float64)
        self._gate = np.ones(n, bool)
        self._t: int | None = None
        # staggers sorted ONCE: the per-round incremental update finds the
        # flip candidates by binary search over these arcs
        self._sort_idx = np.argsort(self.stagger, kind="stable")
        self._sorted_stagger = self.stagger[self._sort_idx]
        self._cache: "OrderedDict[Tuple[bytes, int, int], Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        self._lock = threading.RLock()
        #: telemetry: wall seconds spent inside draw() (sample phase)
        self.sample_seconds = 0.0
        #: telemetry: incremental vs full gate updates
        self.incremental_updates = 0
        self.full_rebuilds = 0
        self.fallback_draws = 0

    # -- gate (churn) ----------------------------------------------------- #

    def _gate_exact(self, t: int, idx=None) -> np.ndarray:
        """The f32 churn gate at round ``t`` (matches ``weights()``'s
        formula op-for-op: f32 multiply-add, f32 mod, strict <)."""
        stg = self.stagger if idx is None else self.stagger[idx]
        if not self.gated:
            return np.ones(stg.shape, bool)
        u = np.mod(np.float32(t) * np.float32(self.churn_rate) + stg,
                   np.float32(1.0))
        return u < np.float32(self.online_frac)

    def _set_leaves(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Write leaves and repair ancestor sums — O(k log n) for k leaves."""
        self._tree[self._m + idx] = values
        nodes = np.unique((self._m + idx) >> 1)
        while nodes.size and nodes[0] >= 1:
            self._tree[nodes] = (self._tree[2 * nodes]
                                 + self._tree[2 * nodes + 1])
            nodes = np.unique(nodes >> 1)
            if nodes[0] == 0:
                break

    def _rebuild(self, t: int) -> None:
        gate = self._gate_exact(t)
        self._tree[:] = 0.0
        self._tree[self._m:self._m + self.n] = gate
        for i in range(self._m - 1, 0, -1):
            self._tree[i] = self._tree[2 * i] + self._tree[2 * i + 1]
        self._gate = gate
        self._t = t
        self.full_rebuilds += 1

    def _arc_candidates(self, lo: float, width: float) -> np.ndarray:
        """Original indices of clients with stagger in [lo, lo+width) mod 1."""
        lo = lo % 1.0
        hi = lo + width
        ss = self._sorted_stagger
        if hi <= 1.0:
            a, b = np.searchsorted(ss, lo), np.searchsorted(ss, hi)
            return self._sort_idx[a:b]
        a = np.searchsorted(ss, lo)
        b = np.searchsorted(ss, hi - 1.0)
        return np.concatenate([self._sort_idx[a:], self._sort_idx[:b]])

    def _advance_one(self, t: int) -> None:
        """Incremental gate update t-1 -> t: only flip candidates — the
        clients whose stagger sits near the two moving gate boundaries —
        are re-evaluated with the exact f32 formula (the arc search is a
        float64 over-approximation widened by a safety margin)."""
        c, f = self.churn_rate, self.online_frac
        # gate on  <=>  stagger in [-t*c, -t*c + f) (mod 1);  both
        # boundaries move by c per round, so flips live in two arcs of
        # width c around the previous boundary positions
        eps = 4.0 * np.finfo(np.float32).eps * (abs(t * c) + 1.0) + 1e-7
        width = min(1.0, c + 2.0 * eps)
        cand = np.concatenate([
            self._arc_candidates(-t * c - eps, width),
            self._arc_candidates(-t * c + f - eps, width)])
        if cand.size:
            cand = np.unique(cand)
            new = self._gate_exact(t, cand)
            flip = new != self._gate[cand]
            if flip.any():
                ci = cand[flip]
                self._gate[ci] = new[flip]
                self._set_leaves(ci, new[flip].astype(np.float64))
        self._t = t
        self.incremental_updates += 1

    def _advance_to(self, t: int) -> None:
        if self._t == t:
            return
        if (self._t is None or t < self._t
                or (t - self._t) * max(self.churn_rate, 1e-9) > 0.5
                or not self.gated):
            self._rebuild(t)
            return
        for step in range(self._t + 1, t + 1):
            self._advance_one(step)

    # -- diurnal ---------------------------------------------------------- #

    def _diurnal(self, t: int, idx) -> np.ndarray:
        """f32 diurnal availability factor in [1-amp, 1] (clamped >= 0)."""
        ph = self.phase[idx]
        w = (np.float32(1.0) - np.float32(self.amp)
             * (np.float32(0.5) + np.float32(0.5) * np.sin(
                 np.float32(2.0 * np.pi)
                 * (np.float32(t) / np.float32(self.period) + ph))))
        return np.maximum(w, np.float32(0.0))

    # -- drawing ---------------------------------------------------------- #

    def _descend(self, u: float) -> int:
        i = 1
        while i < self._m:
            left = self._tree[2 * i]
            if u < left:
                i = 2 * i
            else:
                u -= left
                i = 2 * i + 1
        return i - self._m

    def _draw_impl(self, rng: np.random.Generator, t: int, s: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        removed: Dict[int, float] = {}

        def remove(i: int) -> None:
            removed[i] = self._tree[self._m + i]
            self._set_leaves(np.asarray([i]), np.zeros(1))

        selected: list[int] = []
        budget = _REJECTION_CAP_PER_PICK * (s + 4)
        while len(selected) < s and self._tree[1] >= 0.5:
            if budget <= 0:
                # pathological trough: finish the cohort with an exact
                # O(remaining) Gumbel-top-k over the still-gated clients
                self.fallback_draws += 1
                rem = np.flatnonzero(self._tree[self._m:self._m + self.n]
                                     >= 0.5)
                w = self._diurnal(t, rem).astype(np.float64)
                live = w > 0.0
                rem, w = rem[live], w[live]
                if rem.size:
                    scores = np.log(w) + rng.gumbel(size=rem.size)
                    take = min(s - len(selected), rem.size)
                    picks = rem[np.argsort(-scores)[:take]]
                    for i in picks:
                        remove(int(i))
                        selected.append(int(i))
                break
            budget -= 1
            i = self._descend(rng.random() * self._tree[1])
            w = float(self._diurnal(t, i))
            if w <= 0.0:
                # gated on but diurnally offline (amp == 1 trough): not
                # drawable this round — drop it from the envelope
                remove(i)
                continue
            if rng.random() < w:
                remove(i)
                selected.append(i)

        online_count = len(selected)
        if online_count < s:
            # fewer than s clients online: pad with the lowest-indexed
            # not-selected clients — the Gumbel path's tie-break on its
            # -inf scores
            need = s - online_count
            taken = np.zeros(self.n, bool)
            taken[selected] = True
            pad = np.flatnonzero(~taken)[:need]
            selected.extend(int(i) for i in pad)
        # restore the envelope (the draw is without replacement *within*
        # the cohort only; the tree must reflect the gate for round t+1)
        if removed:
            idx = np.fromiter(removed.keys(), np.int64, len(removed))
            vals = np.fromiter(removed.values(), np.float64, len(removed))
            self._set_leaves(idx, vals)
        clients = np.asarray(selected, np.int32)
        online = np.zeros(s, bool)
        online[:online_count] = True
        return clients, online

    def draw(self, key_data, t, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """The (s,) cohort and its online mask at round ``t``.

        ``key_data`` is the raw uint32 key words (any shape; pass the
        port's int64 key data through ``np.asarray(kd, np.uint32)``);
        results are memoised on ``(key words, t, s)`` so the engine's
        cohort planner and the round share one draw.
        """
        kd = np.ascontiguousarray(np.asarray(key_data, np.uint32))
        t = int(t)
        ck = (kd.tobytes(), t, int(s))
        with self._lock:
            hit = self._cache.get(ck)
            if hit is not None:
                self._cache.move_to_end(ck)
                return hit
            t0 = time.perf_counter()
            self._advance_to(t)
            seq = np.random.SeedSequence([int(x) for x in kd.ravel()]
                                         + [t & 0x7FFFFFFF])
            rng = np.random.Generator(np.random.Philox(seq))
            out = self._draw_impl(rng, t, int(s))
            self._cache[ck] = out
            while len(self._cache) > _CACHE_SIZE:
                self._cache.popitem(last=False)
            self.sample_seconds += time.perf_counter() - t0
            return out
