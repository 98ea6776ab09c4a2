"""Hamiltonian decomposition of complete graphs (paper §3.1, §A.1).

The port's own copy of ``repro/core/hamiltonian.py`` (plain Python on plain
values; no tensors, no device).  It imports nothing of ``repro``.

RailX's rail-ring-based all-to-all interconnection (Lemma 3.1) rests on the
classical result that the complete directed graph K*_k (k != 4, 6) decomposes
into k-1 edge-disjoint directed Hamiltonian cycles [Tillson 1980].

Two constructions are implemented:

* ``walecki_cycles(k)`` — for odd k = 2m+1: m *bidirectional* (undirected)
  Hamiltonian cycles via the Walecki construction the paper sketches in
  Figure 18.  Each undirected cycle supplies two directed cycles, giving the
  full 2m directed decomposition of K*_{2m+1}.
* ``tillson_cycles(k)`` — for even k = 2m >= 8: 2m-1 *directed* Hamiltonian
  cycles (Tillson's theorem guarantees existence).  Tillson's explicit
  construction is intricately case-based; we instead start from the exact
  difference-class decomposition of K*_k into k-1 arc-disjoint permutations
  (class d: i -> i+d mod k; a single k-cycle iff gcd(d, k) = 1) and
  *Hamiltonize* the composite classes by pairwise arc exchanges: the union
  of two arc-disjoint permutations is a 2-in/2-out digraph whose valid
  re-partitions form a flip space over alternating constraint cycles; a
  seeded hill-climb walks that space to reduce the total permutation-cycle
  count to 1 per class.  Every output is certified by
  ``verify_decomposition`` — the climb can retry, never silently fail.
  Results are cached per k.

Every returned cycle is a list of node ids forming a directed Hamiltonian
cycle (implicit edge from last back to first).
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

Cycle = Tuple[int, ...]


# ---------------------------------------------------------------------------
# Odd k: Walecki construction (exact, closed form)
# ---------------------------------------------------------------------------


def walecki_paths(m: int) -> List[Cycle]:
    """m Hamiltonian paths over 2m vertices (paper §A.1).

    Path i is (i, i-1, i+1, i-2, i+2, ..., i+m-1, i-m) mod 2m.
    """
    paths: List[Cycle] = []
    for i in range(m):
        seq = [i]
        for j in range(1, m + 1):
            seq.append((i - j) % (2 * m))
            if j < m:
                seq.append((i + j) % (2 * m))
        paths.append(tuple(seq))
    return paths


def walecki_cycles(k: int) -> List[Cycle]:
    """Decompose K_{2m+1} (k odd) into m undirected Hamiltonian cycles.

    The hub vertex 2m closes each Walecki path into a cycle.
    """
    if k % 2 != 1 or k < 3:
        raise ValueError(f"walecki_cycles requires odd k >= 3, got {k}")
    m = (k - 1) // 2
    return [path + (2 * m,) for path in walecki_paths(m)]


def _directed_from_undirected(cycles: Sequence[Cycle]) -> List[Cycle]:
    """Each undirected Hamiltonian cycle yields two directed ones."""
    out: List[Cycle] = []
    for c in cycles:
        out.append(tuple(c))
        out.append(tuple(reversed(c)))
    return out


# ---------------------------------------------------------------------------
# Even k: difference classes + pairwise Hamiltonization
# ---------------------------------------------------------------------------


def _perm_cycles(succ: Sequence[int]) -> int:
    """Number of cycles of a permutation given as successor list."""
    k = len(succ)
    seen = [False] * k
    cnt = 0
    for s in range(k):
        if seen[s]:
            continue
        cnt += 1
        cur = s
        while not seen[cur]:
            seen[cur] = True
            cur = succ[cur]
    return cnt


def _perm_single_cycle(succ: Sequence[int]) -> Optional[Cycle]:
    """Return the k-cycle of permutation ``succ`` if it is a single cycle."""
    k = len(succ)
    cyc = [0]
    cur = succ[0]
    while cur != 0:
        cyc.append(cur)
        if len(cyc) > k:
            return None
        cur = succ[cur]
    return tuple(cyc) if len(cyc) == k else None


def _pair_exchange(
    sa: List[int], sb: List[int], rng: random.Random, target_obj: int
) -> Optional[Tuple[List[int], List[int]]]:
    """Repartition the union of two arc-disjoint permutations to reduce the
    total permutation-cycle count to ``target_obj`` (2 = both Hamiltonian).

    A valid repartition is a 2-coloring of the union's arcs such that at
    every vertex the two out-arcs (and two in-arcs) differ in color.  Those
    pairing constraints form an even-cycle 2-regular graph over arcs, so
    colorings = independent flips of constraint cycles; we hill-climb the
    flip mask.  Returns (sa', sb') or None if no improvement found.
    """
    k = len(sa)
    arcs: List[Tuple[int, int]] = []
    out_of: List[List[int]] = [[] for _ in range(k)]
    in_of: List[List[int]] = [[] for _ in range(k)]
    for v in range(k):
        for w in (sa[v], sb[v]):
            idx = len(arcs)
            arcs.append((v, w))
            out_of[v].append(idx)
            in_of[w].append(idx)
    mate_tail = {}
    mate_head = {}
    for v in range(k):
        a, b = out_of[v]
        mate_tail[a], mate_tail[b] = b, a
        a, b = in_of[v]
        mate_head[a], mate_head[b] = b, a
    comp = [-1] * len(arcs)
    parity = [0] * len(arcs)
    ncomp = 0
    for start in range(len(arcs)):
        if comp[start] >= 0:
            continue
        cur, use_tail, p = start, True, 0
        while comp[cur] < 0:
            comp[cur] = ncomp
            parity[cur] = p
            cur = mate_tail[cur] if use_tail else mate_head[cur]
            use_tail = not use_tail
            p ^= 1
        ncomp += 1

    def build(flips: List[int]) -> Tuple[List[int], List[int]]:
        s0 = [-1] * k
        s1 = [-1] * k
        for idx, (v, w) in enumerate(arcs):
            if parity[idx] ^ flips[comp[idx]]:
                s1[v] = w
            else:
                s0[v] = w
        return s0, s1

    best: Optional[Tuple[List[int], List[int]]] = None
    base_obj = _perm_cycles(sa) + _perm_cycles(sb)
    best_obj = base_obj
    for _restart in range(8):
        flips = [rng.getrandbits(1) for _ in range(ncomp)]
        s0, s1 = build(flips)
        obj = _perm_cycles(s0) + _perm_cycles(s1)
        stall = 0
        while obj > target_obj and stall < 2 * ncomp + 16:
            c = rng.randrange(ncomp)
            flips[c] ^= 1
            t0, t1 = build(flips)
            new_obj = _perm_cycles(t0) + _perm_cycles(t1)
            if new_obj < obj:
                s0, s1, obj = t0, t1, new_obj
                stall = 0
            elif new_obj == obj and rng.random() < 0.3:
                s0, s1 = t0, t1
                stall += 1
            else:
                flips[c] ^= 1
                stall += 1
        if obj < best_obj or (obj == best_obj and best is None):
            best, best_obj = (s0, s1), obj
        if best_obj <= target_obj:
            break
    return best


def _proper_3coloring(
    k: int, outs: List[List[int]], rng: random.Random
) -> Optional[List[List[int]]]:
    """Randomized backtracking proper 3-coloring of a 3-in/3-out union:
    assign each vertex's 3 out-arcs distinct colors with all in-arcs at each
    vertex also distinctly colored.  Returns 3 successor lists or None."""
    import itertools

    perms_all = list(itertools.permutations(range(3)))
    in_used: List[set] = [set() for _ in range(k)]
    succ = [[-1] * k for _ in range(3)]
    order = list(range(k))
    steps = [0]

    def rec(i: int) -> bool:
        steps[0] += 1
        if steps[0] > 50 * k:
            return False
        if i == k:
            return True
        v = order[i]
        targets = outs[v]
        perms = perms_all[:]
        rng.shuffle(perms)
        for perm in perms:
            if any(c in in_used[t] for t, c in zip(targets, perm)):
                continue
            for t, c in zip(targets, perm):
                in_used[t].add(c)
                succ[c][v] = t
            if rec(i + 1):
                return True
            for t, c in zip(targets, perm):
                in_used[t].discard(c)
                succ[c][v] = -1
        return False

    return succ if rec(0) else None


def _triple_exchange(
    sa: List[int], sb: List[int], sc: List[int],
    rng: random.Random, want_parity: Optional[int], samples: int = 24,
) -> Optional[Tuple[List[int], List[int], List[int]]]:
    """Repartition the union of three arc-disjoint permutations.  Unlike
    pairwise exchange this can change the total cycle-count parity; used to
    fix the global parity obstruction and to de-structure stuck states.
    ``want_parity``: required (c0+c1+c2) % 2, or None for don't-care."""
    k = len(sa)
    outs = [[sa[v], sb[v], sc[v]] for v in range(k)]
    best = None
    best_obj = None
    for _ in range(samples):
        succ = _proper_3coloring(k, outs, rng)
        if succ is None:
            continue
        obj = sum(_perm_cycles(s) for s in succ)
        if want_parity is not None and obj % 2 != want_parity:
            continue
        if best_obj is None or obj < best_obj:
            best, best_obj = succ, obj
    if best is None:
        return None
    return best[0], best[1], best[2]


@lru_cache(maxsize=None)
def _tillson_cached(k: int) -> Tuple[Cycle, ...]:
    for attempt in range(16):
        rng = random.Random(0x7A11 ^ (k * 1_000_003) ^ attempt)
        # Difference classes: succ_d(i) = i + d (mod k); single cycle iff
        # gcd(d, k) == 1.  Arc-disjoint, cover all of K*_k exactly.
        classes: List[List[int]] = [
            [(i + d) % k for i in range(k)] for d in range(1, k)
        ]
        excess = [ _perm_cycles(s) - 1 for s in classes ]

        def triple_shuffle(want_flip: bool) -> None:
            bad = [i for i, e in enumerate(excess) if e > 0]
            if not bad:
                return
            a = rng.choice(bad)
            rest = [i for i in range(len(classes)) if i != a]
            b, c = rng.sample(rest, 2)
            cur = (excess[a] + 1) + (excess[b] + 1) + (excess[c] + 1)
            want = (cur + 1) % 2 if want_flip else None
            res = _triple_exchange(classes[a], classes[b], classes[c], rng, want)
            if res is None:
                return
            new = sum(_perm_cycles(s) for s in res)
            if want_flip or new <= cur:
                for idx, s in zip((a, b, c), res):
                    classes[idx] = s
                    excess[idx] = _perm_cycles(s) - 1

        # Pairwise exchanges preserve (c_i + c_j) mod 2, hence the global
        # parity of sum(c).  Fix the parity gap once with a 3-class
        # repartition (which can change parity), then descend pairwise.
        if (sum(e + 1 for e in excess) - (k - 1)) % 2 == 1:
            for _ in range(16):
                triple_shuffle(want_flip=True)
                if (sum(e + 1 for e in excess) - (k - 1)) % 2 == 0:
                    break

        budget = 400 * k
        stall = 0
        while sum(excess) > 0 and budget > 0:
            budget -= 1
            if stall > 0 and stall % 64 == 0:
                triple_shuffle(want_flip=False)
            bad = [i for i, e in enumerate(excess) if e > 0]
            if not bad:
                break
            a = rng.choice(bad)
            b = rng.randrange(len(classes))
            if b == a:
                continue
            res = _pair_exchange(classes[a], classes[b], rng, target_obj=2)
            if res is None:
                stall += 1
                continue
            sa, sb = res
            new_obj = _perm_cycles(sa) + _perm_cycles(sb)
            cur_obj = (excess[a] + 1) + (excess[b] + 1)
            # Strict improvements always accepted; *lateral* exchanges
            # accepted stochastically — the initial circulant classes are so
            # structured that their pairwise flip spaces are tiny, and
            # lateral shuffling is what unlocks later descent.
            if new_obj < cur_obj:
                classes[a], classes[b] = sa, sb
                excess[a] = _perm_cycles(sa) - 1
                excess[b] = _perm_cycles(sb) - 1
                stall = 0
            elif new_obj == cur_obj and rng.random() < 0.5:
                classes[a], classes[b] = sa, sb
                excess[a] = _perm_cycles(sa) - 1
                excess[b] = _perm_cycles(sb) - 1
                stall += 1
            else:
                stall += 1
        if sum(excess) == 0:
            cycles = [ _perm_single_cycle(s) for s in classes ]
            assert all(c is not None for c in cycles)
            verify_decomposition(k, cycles, directed=True)  # type: ignore[arg-type]
            return tuple(cycles)  # type: ignore[arg-type]
    raise RuntimeError(f"failed to decompose K*_{k} after 16 seeded attempts")


def tillson_cycles(k: int) -> List[Cycle]:
    """Decompose K*_k (k even, k != 4, 6) into k-1 directed Hamiltonian cycles."""
    if k % 2 != 0 or k in (4, 6) or k < 2:
        raise ValueError(f"tillson_cycles requires even k >= 8 (or 2), got {k}")
    if k == 2:
        return [(0, 1)]
    return list(_tillson_cached(k))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def hamiltonian_decomposition(k: int, directed: bool = False) -> List[Cycle]:
    """All-to-all ring decomposition of k nodes (Lemma 3.1).

    For odd k returns m = (k-1)/2 undirected cycles (each rail is a +/- port
    pair, i.e. one bidirectional ring) — the form RailX wires rails with.
    With ``directed=True`` (or even k) returns the directed decomposition
    (k-1 directed Hamiltonian cycles).
    """
    if k in (4, 6):
        raise ValueError(f"K*_{k} admits no Hamiltonian decomposition (k=4,6)")
    if k % 2 == 1:
        und = walecki_cycles(k)
        return _directed_from_undirected(und) if directed else und
    return tillson_cycles(k)


def rails_for_all_to_all(k: int) -> int:
    """Number of rails (bidirectional +/- port pairs) to wire k nodes
    all-to-all via rail rings: (k-1)/2 for odd k, k-1 for even k (each
    directed cycle consumes one +/- pair used unidirectionally)."""
    if k % 2 == 1:
        return (k - 1) // 2
    return k - 1


def verify_decomposition(k: int, cycles: Sequence[Cycle], directed: bool) -> None:
    """Assert the cycles are Hamiltonian, edge-disjoint, and cover K(*)_k."""
    if directed:
        want_edges = {(a, b) for a in range(k) for b in range(k) if a != b}
    else:
        want_edges = {frozenset((a, b)) for a in range(k) for b in range(k) if a < b}
    seen = set()
    for c in cycles:
        if sorted(c) != list(range(k)):
            raise AssertionError(f"cycle {c} is not Hamiltonian over {k} nodes")
        for a, b in zip(c, tuple(c[1:]) + (c[0],)):
            e = (a, b) if directed else frozenset((a, b))
            if e in seen:
                raise AssertionError(f"edge {e} reused")
            seen.add(e)
    if seen != want_edges:
        missing = want_edges - seen
        extra = seen - want_edges
        raise AssertionError(
            f"decomposition does not cover K_{k}: missing={len(missing)} extra={len(extra)}"
        )


def direct_rails_between(k: int, a: int, b: int) -> List[int]:
    """Lemma 3.1: the rail ids on which nodes a and b are directly adjacent
    (two rails for any pair, via the directed decomposition)."""
    cycles = hamiltonian_decomposition(k, directed=True)
    rails = []
    for rid, c in enumerate(cycles):
        for x, y in zip(c, tuple(c[1:]) + (c[0],)):
            if {x, y} == {a, b}:
                rails.append(rid)
                break
    return rails
