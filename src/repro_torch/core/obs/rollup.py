"""Carbon/SLA attribution rollups over a fleet trace.

:class:`CarbonLedgerView` folds the per-job ``admit``/``complete`` spans
into per-zone, per-tier (edge/metro/core lattice tiers) and
per-policy-decision emission + SLA tables.  Every row carries the
*counterfactual* column: the greedy-now baseline (``greedy_g`` — best
feasible cell at slot 0, captured from the already-computed plan grid at
admission, no re-planning), so "kg saved by time / space / overlay
shift" is a first-class queryable number per run.

Decision taxonomy (primary bucket per job, in priority order):

- ``overlay_shift`` — the job migrated mid-flight to another FTN
- ``space_shift``   — sourced from a replica other than its first
- ``time_shift``    — dispatched later than its submission slot
- ``immediate``     — greedy-now was the chosen cell

A job that both space- and time-shifts counts under the higher-priority
bucket; the per-job rows keep the individual booleans for finer slicing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.obs.trace import Span

__all__ = ["CarbonLedgerView", "JobRow"]

_SHIFT_EPS_S = 1.0      # start_t within 1 s of submission = "now"
_DECISIONS = ("overlay_shift", "space_shift", "time_shift", "immediate")


def _zone_of(endpoint: str) -> str:
    """Grid zone of an endpoint (via the memoized route registry)."""
    try:
        from repro_torch.core.carbon.path import discover_path
        return discover_path(endpoint, endpoint).hops[0].zone
    except Exception:
        return "?"


def _tier_of(endpoint: str) -> str:
    """Lattice tier (edge/metro/core) of an endpoint, "-" outside a
    lattice topology (the hand-built testbed endpoints)."""
    from repro_torch.core.carbon import lattice
    return lattice.tier_of_endpoint(endpoint) or "-"


@dataclasses.dataclass
class JobRow:
    """One job's attribution ledger entry, folded from its spans."""
    job: str
    source: str = ""
    ftn: str = ""
    zone: str = "?"
    tier: str = "-"
    planned_g: float = 0.0
    actual_g: float = 0.0
    greedy_g: Optional[float] = None
    sla_miss: bool = False
    migrations: int = 0
    time_shift: bool = False
    space_shift: bool = False
    completed: bool = False

    @property
    def decision(self) -> str:
        if self.migrations:
            return "overlay_shift"
        if self.space_shift:
            return "space_shift"
        if self.time_shift:
            return "time_shift"
        return "immediate"

    @property
    def saved_g(self) -> float:
        """Counterfactual saving vs the greedy-now baseline (0 when no
        baseline was captured or the job did not complete)."""
        if self.greedy_g is None or not self.completed:
            return 0.0
        return self.greedy_g - self.actual_g


class CarbonLedgerView:
    """Fold a span sequence (or a report carrying one) into attribution
    tables.  Aggregation keys: ``zone``, ``tier``, ``decision``."""

    def __init__(self, rows: Sequence[JobRow]) -> None:
        self.rows = list(rows)

    # --- constructors -----------------------------------------------------
    @classmethod
    def from_trace(cls, spans: Iterable[Span]) -> "CarbonLedgerView":
        rows: Dict[str, JobRow] = {}
        for sp in spans:
            if not sp.job:
                continue
            row = rows.get(sp.job)
            if row is None:
                row = rows[sp.job] = JobRow(sp.job)
            if sp.kind == "admit":
                row.source = sp.attr("source", row.source)
                row.ftn = sp.attr("ftn", row.ftn)
                row.planned_g = sp.attr("planned_g", row.planned_g)
                row.greedy_g = sp.attr("greedy_g", row.greedy_g)
                start_t = sp.attr("start_t")
                submitted_t = sp.attr("submitted_t")
                if start_t is not None and submitted_t is not None:
                    row.time_shift = start_t > submitted_t + _SHIFT_EPS_S
                replica0 = sp.attr("replica0")
                if replica0 is not None:
                    row.space_shift = row.source != replica0
            elif sp.kind == "dispatch":
                # re-plans may move the cell between admit and dispatch
                row.source = sp.attr("source", row.source)
                row.ftn = sp.attr("ftn", row.ftn)
            elif sp.kind == "complete":
                row.completed = True
                row.actual_g = sp.attr("actual_g", row.actual_g)
                row.planned_g = sp.attr("planned_g", row.planned_g)
                row.sla_miss = bool(sp.attr("sla_miss", row.sla_miss))
                row.migrations = int(sp.attr("migrations", row.migrations))
        for row in rows.values():
            row.zone = _zone_of(row.source) if row.source else "?"
            row.tier = _tier_of(row.source) if row.source else "-"
        return cls([rows[k] for k in sorted(rows)])

    @classmethod
    def from_report(cls, report) -> "CarbonLedgerView":
        """From any object with a ``trace`` attribute of spans
        (``FleetReport``)."""
        return cls.from_trace(getattr(report, "trace", ()) or ())

    # --- aggregation ------------------------------------------------------
    def _fold(self, key_fn) -> List[dict]:
        acc: Dict[str, dict] = {}
        for row in self.rows:
            key = key_fn(row)
            agg = acc.get(key)
            if agg is None:
                agg = acc[key] = dict(key=key, jobs=0, planned_g=0.0,
                                      actual_g=0.0, greedy_g=0.0,
                                      saved_g=0.0, sla_misses=0,
                                      migrations=0)
            agg["jobs"] += 1
            agg["planned_g"] += row.planned_g
            agg["actual_g"] += row.actual_g
            agg["greedy_g"] += row.greedy_g or 0.0
            agg["saved_g"] += row.saved_g
            agg["sla_misses"] += int(row.sla_miss)
            agg["migrations"] += row.migrations
        return [acc[k] for k in sorted(acc)]

    def by_zone(self) -> List[dict]:
        return self._fold(lambda r: r.zone)

    def by_tier(self) -> List[dict]:
        return self._fold(lambda r: r.tier)

    def by_decision(self) -> List[dict]:
        order = {d: i for i, d in enumerate(_DECISIONS)}
        rows = self._fold(lambda r: r.decision)
        return sorted(rows, key=lambda a: order.get(a["key"], 99))

    def totals(self) -> dict:
        tot = dict(key="total", jobs=0, planned_g=0.0, actual_g=0.0,
                   greedy_g=0.0, saved_g=0.0, sla_misses=0, migrations=0)
        for row in self._fold(lambda r: "total"):
            tot = row
        return tot

    # --- rendering --------------------------------------------------------
    @staticmethod
    def _table(title: str, label: str, rows: List[dict],
               totals: Optional[dict] = None) -> str:
        header = (label, "jobs", "planned_kg", "actual_kg", "greedy_kg",
                  "saved_kg", "sla_miss", "migr")
        body = []
        for agg in rows + ([totals] if totals else []):
            body.append((str(agg["key"]), str(agg["jobs"]),
                         f"{agg['planned_g'] / 1000:.2f}",
                         f"{agg['actual_g'] / 1000:.2f}",
                         f"{agg['greedy_g'] / 1000:.2f}",
                         f"{agg['saved_g'] / 1000:+.2f}",
                         str(agg["sla_misses"]), str(agg["migrations"])))
        widths = [max(len(header[i]), *(len(r[i]) for r in body))
                  for i in range(len(header))] if body else \
                 [len(h) for h in header]
        lines = [title]
        lines.append("  ".join(h.ljust(widths[i]) if i == 0 else
                               h.rjust(widths[i])
                               for i, h in enumerate(header)))
        for r in body:
            lines.append("  ".join(c.ljust(widths[i]) if i == 0 else
                                   c.rjust(widths[i])
                                   for i, c in enumerate(r)))
        return "\n".join(lines)

    def render(self, title: str = "carbon attribution") -> str:
        """Aligned text tables: per-decision, per-tier, per-zone (zones
        capped at the 12 largest emitters to keep lattice runs legible)."""
        tot = self.totals()
        parts = [self._table(f"{title} — by policy decision", "decision",
                             self.by_decision(), tot)]
        tiers = self.by_tier()
        if [t for t in tiers if t["key"] != "-"]:
            parts.append(self._table(f"{title} — by source tier", "tier",
                                     tiers))
        zones = sorted(self.by_zone(), key=lambda a: -a["actual_g"])[:12]
        zones.sort(key=lambda a: str(a["key"]))
        parts.append(self._table(f"{title} — by source zone (top 12)",
                                 "zone", zones))
        saved = tot["saved_g"] / 1000.0
        n = tot['jobs']
        parts.append(f"counterfactual: greedy-now baseline "
                     f"{tot['greedy_g'] / 1000:.2f} kg vs actual "
                     f"{tot['actual_g'] / 1000:.2f} kg -> {saved:+.2f} kg "
                     f"saved across {n} jobs "
                     f"({tot['sla_misses']} SLA misses)")
        return "\n\n".join(parts)
