"""Real-trace ingestion: ElectricityMaps-style CSV → prefix-sum grids.

The synthetic :class:`GridRegion` traces carry the repo; this module is the
path for *measured* hourly carbon intensity. A CSV of
``datetime,zone,carbon_intensity_gco2_kwh`` rows is validated (monotone
timestamps, consistent duplicates, bounded gaps, values above the field's
clamp floor), resampled to the hourly grid (sub-hourly samples bucket-mean
into their hour; interior gaps up to ``max_gap_h`` gap-fill by linear
interpolation — both deterministic), and **quantized to 2⁻²⁰ gCO₂/kWh** so
the install → read-back → export chain below is bit-exact, not just close.

Installation reuses the existing engine wholesale: a trace zone registers a
degenerate :class:`GridRegion` (``base_ci = diurnal = dip = 0``,
``noise = 1``) and pre-seeds the field's hashed-noise table with
``u = value/2 + 0.5``, so the shared formula
``v = base + noise·((u − 0.5)·2)`` reproduces the trace **exactly** in every
backend — numpy ``zone_ci``, the scalar hot path, and the torch and CUDA
cell tables all read the same table. (The /2 and ·2 are power-of-two
scalings and the +0.5 is exact under the quantization, hence bit-stability;
``tests/test_torch_workloads.py`` pins the round trip.) Hours outside the ingested
window fall back to hashed noise in (−1, 1) and clamp to the formula floor.

``synthetic_lattice_csv`` generates a hermetic N-zone fixture from a
:class:`ZoneLattice`'s deterministic traces — the 200-zone test corpus
needs no network and no bundled megabytes.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import io
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon.field import (CarbonField, default_field,
                                           register_field_setup)
from repro_torch.core.carbon.intensity import (PAPER_WINDOW_T0, GridRegion,
                                               register_region)

CSV_HEADER = "datetime,zone,carbon_intensity_gco2_kwh"
# accepted aliases per column (ElectricityMaps exports vary)
_COL_ALIASES = (("datetime", "timestamp"),
                ("zone", "zone_id"),
                ("carbon_intensity_gco2_kwh", "carbon_intensity_avg",
                 "carbon_intensity"))
_QUANT = float(2 ** 20)
# the field formula clamps zone CI at 1.0; trace values below that floor
# cannot round-trip, and real grid CI never goes there
MIN_CI = 1.0
MAX_CI = 5000.0


class IngestError(ValueError):
    """Malformed trace input: the row/zone context is in the message."""


def _quantize(v: float) -> float:
    return round(v * _QUANT) / _QUANT


def _parse_ts(text: str, line: int) -> int:
    """ISO-8601 → unix seconds. Explicit offsets normalize to UTC; naive
    timestamps are taken as UTC ('Z' suffix included)."""
    raw = text.strip()
    try:
        dt = _dt.datetime.fromisoformat(raw.replace("Z", "+00:00"))
    except ValueError:
        raise IngestError(f"line {line}: bad timestamp {text!r}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp())


@dataclasses.dataclass(frozen=True)
class ZoneTrace:
    """One zone's validated hourly trace on the unix-hour grid."""
    zone: str
    hour0: int                      # unix hour index of values[0]
    values: np.ndarray              # (n,) float64, quantized, >= MIN_CI
    filled: Tuple[int, ...] = ()    # offsets into values that were gap-filled

    @property
    def t0(self) -> float:
        return self.hour0 * 3600.0

    @property
    def hours(self) -> int:
        return len(self.values)


def parse_csv(text: str, *, max_gap_h: int = 6) -> Dict[str, ZoneTrace]:
    """CSV text → per-zone hourly traces. Deterministic accept/reject:

    * non-monotone timestamps within a zone → :class:`IngestError`
    * duplicate timestamps: identical values collapse, conflicting raise
    * sub-hourly samples bucket-mean into their hour
    * interior gaps of ≤ ``max_gap_h`` missing hours linearly interpolate
      (recorded in ``ZoneTrace.filled``); longer gaps raise
    * values outside [MIN_CI, MAX_CI] or non-finite raise
    """
    lines = io.StringIO(text).read().splitlines()
    rows = [ln for ln in lines if ln.strip()]
    if not rows:
        raise IngestError("empty input")
    header = [h.strip().lower() for h in rows[0].split(",")]
    if len(header) != 3 or not all(
            header[i] in aliases for i, aliases in enumerate(_COL_ALIASES)):
        raise IngestError(f"bad header {rows[0]!r}; expected {CSV_HEADER}")
    # zone -> {unix_ts -> [values]}, insertion-ordered
    samples: Dict[str, Dict[int, List[float]]] = {}
    last_ts: Dict[str, int] = {}
    for i, row in enumerate(rows[1:], start=2):
        parts = row.split(",")
        if len(parts) != 3:
            raise IngestError(f"line {i}: expected 3 fields, got "
                              f"{len(parts)}")
        ts = _parse_ts(parts[0], i)
        zone = parts[1].strip()
        if not zone:
            raise IngestError(f"line {i}: empty zone")
        try:
            val = float(parts[2])
        except ValueError:
            raise IngestError(f"line {i}: bad value {parts[2]!r}") from None
        if not math.isfinite(val) or not MIN_CI <= val <= MAX_CI:
            raise IngestError(f"line {i}: value {val!r} outside "
                              f"[{MIN_CI}, {MAX_CI}]")
        prev = last_ts.get(zone)
        if prev is not None and ts < prev:
            raise IngestError(f"line {i}: non-monotone timestamp for zone "
                              f"{zone!r}")
        if prev is not None and ts == prev:
            if val not in samples[zone][ts]:
                raise IngestError(f"line {i}: conflicting duplicate "
                                  f"timestamp for zone {zone!r}")
            continue                       # identical duplicate: collapse
        last_ts[zone] = ts
        samples.setdefault(zone, {}).setdefault(ts, []).append(val)
    out: Dict[str, ZoneTrace] = {}
    for zone, by_ts in samples.items():
        # bucket-mean into hours (sub-hourly resample; hourly = identity)
        hours: Dict[int, List[float]] = {}
        for ts, vals in by_ts.items():
            hours.setdefault(ts // 3600, []).extend(vals)
        hs = sorted(hours)
        vals_q = {h: _quantize(sum(hours[h]) / len(hours[h])) for h in hs}
        hour0, hour_last = hs[0], hs[-1]
        values = np.empty(hour_last - hour0 + 1, dtype=np.float64)
        filled: List[int] = []
        for (h_lo, h_hi) in zip(hs, hs[1:]):
            gap = h_hi - h_lo - 1
            if gap > max_gap_h:
                raise IngestError(f"zone {zone!r}: {gap}h gap at hour "
                                  f"{h_lo + 1} exceeds max_gap_h="
                                  f"{max_gap_h}")
            for j in range(1, gap + 1):
                off = h_lo + j - hour0
                frac = j / (gap + 1)
                values[off] = _quantize(
                    vals_q[h_lo] * (1.0 - frac) + vals_q[h_hi] * frac)
                filled.append(off)
        for h in hs:
            values[h - hour0] = vals_q[h]
        out[zone] = ZoneTrace(zone=zone, hour0=hour0, values=values,
                              filled=tuple(filled))
    return out


def load_csv(path: str, *, max_gap_h: int = 6) -> Dict[str, ZoneTrace]:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_csv(fh.read(), max_gap_h=max_gap_h)


# --- field installation ----------------------------------------------------
def trace_zone_region(zone: str) -> GridRegion:
    """The degenerate region a trace zone registers: all structure lives in
    the pre-seeded noise table, so the shared formula emits the trace."""
    return GridRegion(name=f"trace:{zone}", zone=zone, base_ci=0.0,
                      diurnal_amp=0.0, solar_dip=0.0, noise=1.0,
                      peak_hour=0.0)


def _register_trace_zones(zones: Sequence[str]) -> None:
    """``register_field_setup`` entrypoint: re-create the REGIONS entries in
    a thawing worker (the noise values themselves travel in the frozen
    field's zone_noise snapshot)."""
    for zone in zones:
        register_region(trace_zone_region(zone))


def install_traces(traces: Dict[str, ZoneTrace],
                   field: Optional[CarbonField] = None) -> None:
    """Wire parsed traces into a live field: register the degenerate
    regions, pre-seed the hashed-noise table with the exact-encoding
    ``u = value/2 + 0.5``, and record the region registration for
    spawn-worker replay."""
    f = field if field is not None else default_field()
    _register_trace_zones(tuple(traces))
    f._zone_noise.restore([
        (tr.zone, tr.hour0, tr.values / 2.0 + 0.5)
        for tr in traces.values()])
    register_field_setup(
        "repro_torch.core.carbon.ingest:_register_trace_zones",
        tuple(sorted(traces)))


def export_csv(field: CarbonField, traces: Dict[str, ZoneTrace]) -> str:
    """Read each trace's window back out of the field (uncalibrated — the
    raw stored trace) as canonical CSV. ``export_csv(f, t)`` after
    ``install_traces(t, f)`` is bit-identical to the canonical form of the
    input."""
    lines = [CSV_HEADER]
    for zone in traces:
        tr = traces[zone]
        ts = tr.t0 + 3600.0 * np.arange(tr.hours)
        vals = field.zone_ci(zone, ts, calibrated=False)
        for h, v in zip(range(tr.hour0, tr.hour0 + tr.hours), vals):
            stamp = _dt.datetime.fromtimestamp(
                h * 3600, tz=_dt.timezone.utc).isoformat()
            lines.append(f"{stamp},{zone},{float(v)!r}")
    return "\n".join(lines) + "\n"


def traces_to_csv(traces: Dict[str, ZoneTrace]) -> str:
    """Canonical CSV of parsed traces (same format export_csv emits)."""
    lines = [CSV_HEADER]
    for zone in traces:
        tr = traces[zone]
        for off, v in enumerate(tr.values):
            stamp = _dt.datetime.fromtimestamp(
                (tr.hour0 + off) * 3600, tz=_dt.timezone.utc).isoformat()
            lines.append(f"{stamp},{zone},{float(v)!r}")
    return "\n".join(lines) + "\n"


# --- hermetic fixture generation -------------------------------------------
def synthetic_lattice_csv(zones: int = 200, hours: int = 48, *,
                          t0: float = PAPER_WINDOW_T0,
                          prefix: str = "TRC") -> str:
    """A deterministic N-zone hourly CSV sampled from the canonical
    :class:`ZoneLattice` traces (quantized, so ingest → export is the
    identity). Zone ids are prefixed — the fixture's trace zones must not
    collide with the lattice's own synthetic registrations."""
    from repro_torch.core.carbon.lattice import default_lattice
    lat = default_lattice(zones)
    hour0 = int(t0 // 3600)
    lines = [CSV_HEADER]
    for cell in lat.cells:
        region = lat.regions[cell]
        zone = f"{prefix}-{region.zone}"
        for h in range(hour0, hour0 + hours):
            v = _quantize(region.ci(h * 3600.0))
            stamp = _dt.datetime.fromtimestamp(
                h * 3600, tz=_dt.timezone.utc).isoformat()
            lines.append(f"{stamp},{zone},{v!r}")
    return "\n".join(lines) + "\n"
