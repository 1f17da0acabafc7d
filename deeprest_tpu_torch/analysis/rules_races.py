"""Rule pack RC: interprocedural lockset race detection (graftrace).

Four rules over :mod:`locksets`' compositional analysis, in the RacerD
lineage ([4] in PAPERS.md).  The pack exists because the TH heuristics
are ``ast.Store``-syntactic and the last two rounds each shipped a race
they structurally could not see:

- round 23: dispatch read a freshly-spilled params tree — checked under
  the engine lock, acted after release — and minted a second C++
  dispatch-cache signature (fixed by snapshotting params under the
  lock).
- round 24: ``stats()`` iterated the wire latency deque off-lock
  against ``commit()``'s locked ``extend`` ("deque mutated during
  iteration" under a /healthz scrape).  ``self._lat.extend(...)`` is an
  ``ast.Load`` of ``_lat`` plus a call — invisible to
  ``written_outside_init``, so TH001/TH004 stayed silent.

Every finding carries a TWO-SITE WITNESS: the deviating access is the
primary location and the guarded witness rides in ``Finding.related``
(SARIF ``relatedLocations``), with the call chain from each concurrent
root inline in the message.  One-owner-per-site: an attribute TH001 or
TH004 already reports is never re-reported here.
"""

from __future__ import annotations

from typing import Iterator

from deeprest_tpu_torch.analysis.core import Finding, Project, Rule, register
from deeprest_tpu_torch.analysis.locksets import (
    LOCK_ANY, MANY, ClassLocks, LockAccess, LocksetAnalysis,
)


def _verb(acc: LockAccess) -> str:
    if acc.mutation:
        return "mutated"
    return "written" if acc.write else "read"


class _RaceRule(Rule):
    """Shared iteration: one lockset model per interesting class."""

    def run(self, project: Project) -> Iterator[Finding]:
        analysis = LocksetAnalysis.of(project)
        for cls in analysis.iter_classes():
            yield from self.check(analysis, cls)

    def check(self, analysis: LocksetAnalysis,
              cls: ClassLocks) -> Iterator[Finding]:
        raise NotImplementedError


@register
class RC001UnguardedRacyPair(_RaceRule):
    id = "RC001"
    title = ("shared attribute with an inferred lock guard accessed "
             "unguarded on a concurrent path (write/write or "
             "write/read, two-site witness)")
    guards = ("round 24 shipped stats() iterating the wire receiver's "
              "latency deque off-lock against commit()'s locked "
              "extend — 'deque mutated during iteration' under a "
              "/healthz scrape.  The mutation is an ast.Load plus a "
              "method call, so TH001/TH004 never saw a write; only "
              "dynamic review caught it")

    def check(self, analysis: LocksetAnalysis,
              cls: ClassLocks) -> Iterator[Finding]:
        for attr in cls.state_attrs():
            if analysis.owned_by_th(cls, attr):
                continue
            accesses = cls.shared_accesses(attr)
            guarded = [a for a in accesses if cls.effective_locks(a)]
            unguarded = [a for a in accesses
                         if not cls.effective_locks(a)]
            if not guarded or not unguarded:
                continue
            guard, covered, total = cls.inferred_guard(accesses)
            if guard is None:
                continue
            bad_pool = [a for a in unguarded if a.write]
            if not bad_pool and any(a.write for a in guarded):
                bad_pool = unguarded
            hit = None
            for bad in sorted(bad_pool, key=lambda a: a.line):
                witnesses = sorted(
                    guarded,
                    key=lambda a: (guard not in cls.effective_locks(a),
                                   not a.write, a.line))
                for wit in witnesses:
                    chains = cls.concurrent_pair(bad.unit, wit.unit)
                    if chains is not None:
                        hit = (bad, wit, chains)
                        break
                if hit:
                    break
            if hit is None:
                continue
            bad, wit, (chain_bad, chain_wit) = hit
            yield Finding(
                cls.sf.rel, bad.line, bad.col, self.id,
                f"{cls.name}.{attr} is {_verb(bad)} in {bad.unit}() "
                f"with NO lock [{chain_bad}], but {wit.unit}() line "
                f"{wit.line} has it {_verb(wit)}"
                f" under self.{guard} [{chain_wit}] — inferred "
                f"guard self.{guard} covers {covered}/{total} "
                "accesses; this deviation is a data race, hold the "
                "lock here too",
                related=((cls.sf.rel, wit.line, wit.col,
                          f"guarded witness: {wit.unit}() holds "
                          f"self.{guard}"),))


@register
class RC002SplitLockGuard(_RaceRule):
    id = "RC002"
    title = ("one attribute guarded by DIFFERENT locks at different "
             "sites — two locks serialize nothing")
    guards = ("the wire receiver carries three locks (_conns_lock, "
              "_stats_lock, _commit_lock); the round-24 review moved "
              "the latency deque between them twice.  Every access "
              "being 'locked' satisfies TH004 even when site A holds "
              "_stats_lock and site B holds _commit_lock — exactly the "
              "round-24 race with an alibi")

    def check(self, analysis: LocksetAnalysis,
              cls: ClassLocks) -> Iterator[Finding]:
        if len(cls.lock_attrs) < 2:
            return
        for attr in cls.state_attrs():
            if analysis.owned_by_th(cls, attr):
                continue
            accesses = cls.shared_accesses(attr)
            if not accesses or not any(a.write for a in accesses):
                continue
            eff = [(a, cls.effective_locks(a)) for a in accesses]
            if any(not locks for _a, locks in eff):
                continue                  # RC001's domain
            concrete = [(a, frozenset(l for l in locks if l != LOCK_ANY))
                        for a, locks in eff
                        if LOCK_ANY not in locks]
            if len(concrete) < 2:
                continue
            guard, _cov, _tot = cls.inferred_guard(accesses)
            if guard is None:
                continue
            deviants = [a for a, locks in concrete
                        if locks and guard not in locks]
            witnesses = [a for a, locks in concrete if guard in locks]
            if not deviants or not witnesses:
                continue
            hit = None
            pool = ([d for d in deviants if d.write] or deviants)
            for bad in sorted(pool, key=lambda a: a.line):
                for wit in sorted(witnesses,
                                  key=lambda a: (not a.write, a.line)):
                    chains = cls.concurrent_pair(bad.unit, wit.unit)
                    if chains is not None:
                        hit = (bad, wit, chains)
                        break
                if hit:
                    break
            if hit is None:
                continue
            bad, wit, (chain_bad, chain_wit) = hit
            other = sorted(cls.effective_locks(bad) - {LOCK_ANY})[0]
            yield Finding(
                cls.sf.rel, bad.line, bad.col, self.id,
                f"{cls.name}.{attr} is {_verb(bad)} under "
                f"self.{other} in {bad.unit}() [{chain_bad}] but "
                f"{_verb(wit)} under self.{guard} in {wit.unit}() "
                f"line {wit.line} [{chain_wit}] — different locks "
                "serialize nothing; guard every access with "
                f"self.{guard}",
                related=((cls.sf.rel, wit.line, wit.col,
                          f"majority-lock witness: {wit.unit}() holds "
                          f"self.{guard}"),))


@register
class RC003CheckThenAct(_RaceRule):
    id = "RC003"
    title = ("check-then-act: the guard is released between a locked "
             "read and the dependent locked write in the same "
             "function")
    guards = ("round 23's dispatch raced a fleet spill: it read the "
              "params tree under the engine lock, released, and acted "
              "on the stale snapshot while the spill replaced the "
              "buffers — minting a second C++ dispatch-cache "
              "signature.  Fixed by snapshotting params and "
              "dispatching inside ONE critical section "
              "(serve/fused.py)")

    def check(self, analysis: LocksetAnalysis,
              cls: ClassLocks) -> Iterator[Finding]:
        for name, unit in sorted(cls.units.items()):
            if len(unit.sections) < 2 or not unit.roots:
                continue
            many = (len(unit.roots) >= 2
                    or any(cls.roots.get(r) == MANY for r in unit.roots))
            if not many:
                continue                 # a single thread runs this unit
            chain = next(f"{r}: {c}"
                         for r, c in sorted(unit.roots.items()))
            seen: set[str] = set()
            sections = sorted(unit.sections, key=lambda s: s.line)
            for i, s1 in enumerate(sections):
                for s2 in sections[i + 1:]:
                    if s2.line <= s1.end:
                        continue         # nested/overlapping, not serial
                    common = s1.locks & s2.locks
                    if not common:
                        continue
                    lock = sorted(common)[0]
                    for attr in sorted(s1.reads):
                        if (attr in s1.writes or attr not in s2.writes
                                or attr in s2.reads or attr in seen
                                or analysis.owned_by_th(cls, attr)):
                            continue
                        seen.add(attr)
                        yield Finding(
                            cls.sf.rel, s2.writes[attr], 0, self.id,
                            f"{cls.name}.{attr}: check-then-act in "
                            f"{name}() [{chain}] — line "
                            f"{s1.reads[attr]} reads it under "
                            f"self.{lock}, the lock is released, and "
                            f"line {s2.writes[attr]} writes it under a "
                            "fresh acquire; a concurrent writer can "
                            "interleave between the sections, so the "
                            "write acts on a stale check — widen one "
                            "critical section over both, or revalidate "
                            "before the act",
                            related=((cls.sf.rel, s1.reads[attr], 0,
                                      "the check: read under "
                                      f"self.{lock}, released before "
                                      "the act"),))


@register
class RC004LockedStateEscape(_RaceRule):
    id = "RC004"
    title = ("lock-protected mutable container escapes by reference: "
             "returned from inside the critical section")
    guards = ("the round-24 wire stats() fix snapshots the latency "
              "deque under the lock (sorted(self._lat)) precisely "
              "because returning the live container would hand the "
              "caller a reference that outlives the critical section — "
              "every iteration after return races commit()'s extend, "
              "the same 'deque mutated during iteration' crash one "
              "refactor away")

    def check(self, analysis: LocksetAnalysis,
              cls: ClassLocks) -> Iterator[Finding]:
        for name, unit in sorted(cls.units.items()):
            for esc in unit.escapes:
                if analysis.owned_by_th(cls, esc.attr):
                    continue
                lock = sorted(esc.locks - {LOCK_ANY})
                lock_name = lock[0] if lock else sorted(cls.lock_attrs)[0]
                init = cls.units.get("__init__")
                rel_line = None
                if init is not None:
                    for a in init.accesses:
                        if a.attr == esc.attr and a.write:
                            rel_line = (a.line, a.col)
                            break
                related = ()
                if rel_line is not None:
                    related = ((cls.sf.rel, rel_line[0], rel_line[1],
                                f"the container: {cls.name}.{esc.attr} "
                                "is created here"),)
                yield Finding(
                    cls.sf.rel, esc.line, esc.col, self.id,
                    f"{cls.name}.{esc.attr} is returned by reference "
                    f"from inside the self.{lock_name} critical "
                    f"section in {name}() — the caller iterates the "
                    "live container AFTER the lock is released, racing "
                    "every guarded mutation; return a snapshot "
                    "(list(...)/dict(...)/.copy()) instead",
                    related=related)
