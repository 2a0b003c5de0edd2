"""Grid-region carbon-intensity traces (the Electricity-Maps/WattTime role).

No live API exists inside the runtime, so every region carries a
deterministic seeded trace generator: diurnal solar dip + evening ramp +
weekly structure + weather-band noise, affinely calibrated per region.
The UC→TACC path average over the paper's 51-hour window (2024-04-14 00:00
UTC onward) is calibrated to the published extremes min=255.714 /
max=488.6 gCO₂/kWh (Fig. 3) — see ``tests/test_carbon_paper_claims.py``.

Units: gCO₂eq/kWh. Time: unix seconds (UTC).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

# the paper's measurement window (Fig. 2/3): April 14-16 2024, 51 hours
PAPER_WINDOW_T0 = 1713052800.0          # 2024-04-14T00:00:00Z
PAPER_WINDOW_HOURS = 51
PAPER_MIN_CI = 255.714                  # §4.1
PAPER_MAX_CI = 488.6                    # §4.1


@dataclasses.dataclass(frozen=True)
class GridRegion:
    """One balancing authority / electricity-maps zone."""
    name: str
    zone: str                 # electricity-maps style zone id
    base_ci: float            # mean gCO2/kWh
    diurnal_amp: float        # day/night swing amplitude
    solar_dip: float          # midday renewables dip depth
    noise: float              # weather-band noise amplitude
    peak_hour: float = 19.0   # local evening peak (UTC-ish offset folded in)

    def _noise(self, hour_idx: int) -> float:
        h = hashlib.blake2b(f"{self.zone}:{hour_idx}".encode(),
                            digest_size=8).digest()
        u = int.from_bytes(h, "big") / 2**64
        return (u - 0.5) * 2.0            # [-1, 1)

    def ci(self, t: float) -> float:
        """Carbon intensity at unix time t (piecewise-hourly, like the APIs)."""
        hour_idx = int(t // 3600.0)
        h_of_day = (t / 3600.0) % 24.0
        dow = int(t // 86400.0) % 7
        # evening peak
        v = self.base_ci + self.diurnal_amp * math.cos(
            2 * math.pi * (h_of_day - self.peak_hour) / 24.0)
        # midday solar dip (gaussian around 13:00)
        v -= self.solar_dip * math.exp(-0.5 * ((h_of_day - 13.0) / 2.5) ** 2)
        # weekends are ~6% cleaner (lower industrial load)
        if dow in (5, 6):
            v *= 0.94
        v += self.noise * self._noise(hour_idx)
        return max(v, 1.0)

    def forecast_naive(self, t: float, horizon_s: float) -> float:
        """Persistence forecast (yesterday, same time)."""
        return self.ci(t + horizon_s - 86400.0)


# --- region registry -------------------------------------------------------
# base/amp values are representative of 2024 public Electricity Maps data for
# the balancing authorities the paper's testbed spans (MISO for UC/Chicago,
# SPP mid-route, ERCOT for TACC/Austin, NYISO for the Buffalo M1 node).
REGIONS: Dict[str, GridRegion] = {r.zone: r for r in [
    GridRegion("MISO (Chicago)",     "US-MIDW-MISO", 520.0, 95.0, 120.0, 28.0),
    GridRegion("SPP (Kansas)",       "US-CENT-SWPP", 460.0, 90.0, 150.0, 30.0),
    GridRegion("ERCOT (Texas)",      "US-TEX-ERCO",  410.0, 85.0, 170.0, 32.0),
    GridRegion("NYISO (Upstate NY)", "US-NY-NYIS",   250.0, 45.0,  40.0, 18.0),
    GridRegion("PJM (Mid-Atlantic)", "US-MIDA-PJM",  480.0, 80.0,  90.0, 25.0),
    GridRegion("CAISO (California)", "US-CAL-CISO",  290.0, 70.0, 160.0, 26.0),
    GridRegion("BPA (Pacific NW)",   "US-NW-BPAT",   120.0, 25.0,  15.0, 10.0),
    GridRegion("Hydro Quebec",       "CA-QC",         35.0,  6.0,   2.0,  3.0),
    GridRegion("Germany",            "DE",           380.0, 90.0, 140.0, 30.0),
    GridRegion("France",             "FR",            60.0, 18.0,  12.0,  8.0),
]}


def register_region(region: GridRegion) -> GridRegion:
    """Add one zone to the live registry (the lattice / trace-ingestion
    growth path). Re-registering the same zone with identical parameters is
    a no-op; conflicting parameters raise — two subsystems silently fighting
    over one zone id would corrupt every cached trace derived from it.
    """
    prev = REGIONS.get(region.zone)
    if prev is not None and prev != region:
        raise ValueError(f"zone {region.zone!r} already registered with "
                         f"different parameters")
    REGIONS[region.zone] = region
    return region


def get_region(zone: str) -> GridRegion:
    return REGIONS[zone]


def region_ci(zone: str, t: float) -> float:
    return REGIONS[zone].ci(t)


# --- Fig. 4: US state carbon index (emissionsindex.org, 2023) --------------
# The paper quotes the extremes exactly: Wyoming 1919, Vermont 1. The other
# eight states are representative values from the same public index.
STATE_CARBON_INDEX: Dict[str, int] = {
    "Wyoming": 1919,          # quoted in §4.2
    "West Virginia": 1875,
    "Kentucky": 1712,
    "Indiana": 1564,
    "Missouri": 1480,
    "Texas": 903,
    "Illinois": 551,
    "California": 436,
    "New York": 389,
    "Vermont": 1,             # quoted in §4.2
}


# --- paper-window calibration ----------------------------------------------
def _uc_tacc_raw_hourly(hour: int, route_zones: Tuple[str, ...]) -> float:
    t = PAPER_WINDOW_T0 + hour * 3600.0
    return sum(REGIONS[z].ci(t) for z in route_zones) / len(route_zones)


_UC_TACC_ZONES = ("US-MIDW-MISO", "US-MIDW-MISO", "US-MIDW-MISO",
                  "US-CENT-SWPP", "US-CENT-SWPP",
                  "US-TEX-ERCO", "US-TEX-ERCO", "US-TEX-ERCO")


def _calibration() -> Tuple[float, float]:
    """Affine (a, b) such that a*raw+b maps the raw UC→TACC 51-h hourly path
    average exactly onto [PAPER_MIN_CI, PAPER_MAX_CI]."""
    vals = [_uc_tacc_raw_hourly(h, _UC_TACC_ZONES)
            for h in range(PAPER_WINDOW_HOURS)]
    lo, hi = min(vals), max(vals)
    a = (PAPER_MAX_CI - PAPER_MIN_CI) / (hi - lo)
    b = PAPER_MIN_CI - a * lo
    return a, b


_CAL: Optional[Tuple[float, float]] = None


def calibrated_ci(zone: str, t: float) -> float:
    """Region CI with the paper-window affine calibration applied (keeps the
    relative structure of every region, pins the UC→TACC path average to the
    published Fig. 3 extremes)."""
    a, b = get_calibration()
    return max(a * REGIONS[zone].ci(t) + b, 0.5)


def get_calibration() -> Tuple[float, float]:
    """The paper-window affine (a, b), computed once and cached. Shared by
    the scalar path and the vectorized CarbonField so both apply the exact
    same calibration constants."""
    global _CAL
    if _CAL is None:
        _CAL = _calibration()
    return _CAL


@dataclasses.dataclass
class CITrace:
    """Sampled CI history/forecast for one zone (what a scheduler consumes)."""
    zone: str
    t0: float
    dt_s: float = 3600.0
    n: int = PAPER_WINDOW_HOURS
    calibrated: bool = True

    def values(self):
        f = calibrated_ci if self.calibrated else region_ci
        return [f(self.zone, self.t0 + i * self.dt_s) for i in range(self.n)]

    def at(self, t: float) -> float:
        f = calibrated_ci if self.calibrated else region_ci
        return f(self.zone, t)
