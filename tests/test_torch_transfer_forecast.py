"""The forecasters, mid-transfer migration and ``path_power_w``: the port's
copies against the reference's, bit for bit.

``PersistenceForecaster`` (``predict`` and its loop oracle
``predict_reference``) and ``HarmonicForecaster`` (``fit``, ``predict``,
``rmse``) on the histories of ``tests/test_scheduler.py``;
``migrate_transfer`` on ``tests/test_transfer.py``'s hand-off case and on
``examples/overlay_migration.py``'s scenario (the same FTN sequence,
migrations, final state, ledger samples and overlay events); and
``CarbonField.path_power_w`` over several paths and rates, as
``tests/test_carbon_field.py`` checks it against the device weights.
"""
import dataclasses

import numpy as np
import pytest

import _torch_ref as ref
from repro.core.carbon import field as r_field
from repro.core.carbon.energy import HOST_PROFILES as R_HOSTS
from repro.core.carbon.path import discover_path as r_discover
from repro.core.scheduler import forecast as r_forecast
from repro.core.scheduler import overlay as r_overlay
from repro.core.transfer import engine as r_engine
from repro.core.transfer.migrate import migrate_transfer as r_migrate
from repro_torch.core import scheduler, transfer
from repro_torch.core.carbon import field
from repro_torch.core.carbon.energy import HOST_PROFILES
from repro_torch.core.carbon.path import discover_path
from repro_torch.core.scheduler import forecast, overlay
from repro_torch.core.transfer import engine, migrate
from repro_torch.core.transfer.migrate import MigratedTransfer

T0 = ref.T0
HOURS = [T0 + h * 3600.0 for h in range(48)]


def _histories():
    """tests/test_scheduler.py's two histories: the uc->tacc path CI and a
    sawtooth."""
    p = discover_path("uc", "tacc")
    return {"path_ci": [p.ci(t) for t in HOURS],
            "sawtooth": [float(h % 24) * 10.0 + 100.0 for h in range(48)]}


def _probes(pe):
    """test_persistence_modular_fold_matches_loop_oracle's probes, the
    next day's hours and a far-future query."""
    last = HOURS[-1]
    out = [T0 - 3600.0, T0, last, last + 0.25, last + pe.period_s,
           last + 3.0 * pe.period_s, T0 + 17 * 86400.0 + 12345.0]
    out += [T0 + off * 3600.0 for off in range(0, 30 * 24, 7)]
    out += [T0 + hh * 3600.0 for hh in range(48, 60)]
    return out + [T0 + 1e7 * pe.period_s + 5 * 3600.0]


@pytest.mark.parametrize("history", ["path_ci", "sawtooth"])
def test_persistence_forecaster_matches_reference(history):
    hist = _histories()[history]
    got = forecast.PersistenceForecaster(HOURS, hist)
    want = r_forecast.PersistenceForecaster(HOURS, hist)
    for t in _probes(got):
        assert got.predict(t) == want.predict(t), t
        if t < T0 + 1e6:               # the loop oracle is O(t / period)
            assert got.predict_reference(t) == want.predict_reference(t), t
            assert got.predict_reference(t) == got.predict(t), t


@pytest.mark.parametrize("history", ["path_ci", "sawtooth"])
@pytest.mark.parametrize("n_harmonics", [1, 2, 3])
def test_harmonic_forecaster_matches_reference(history, n_harmonics):
    hist = _histories()[history]
    got = forecast.HarmonicForecaster(HOURS, hist,
                                      n_harmonics=n_harmonics).fit()
    want = r_forecast.HarmonicForecaster(HOURS, hist,
                                         n_harmonics=n_harmonics).fit()
    assert got._coef.tolist() == want._coef.tolist()
    for hh in range(-3, 72, 5):
        t = T0 + hh * 3600.0 + 17.0
        assert got.predict(t) == want.predict(t), hh
    assert got.rmse() == want.rmse()
    lazy = forecast.HarmonicForecaster(HOURS, hist,
                                       n_harmonics=n_harmonics)
    assert lazy.predict(T0 + 50 * 3600.0) == want.predict(T0 + 50 * 3600.0)


def test_make_forecaster_and_exports_match_reference():
    hist = _histories()["path_ci"]
    for kind in ("persistence", "harmonic"):
        got = forecast.make_forecaster(kind, HOURS, hist)
        want = r_forecast.make_forecaster(kind, HOURS, hist)
        assert type(got).__name__ == type(want).__name__
        assert got.predict(T0 + 55 * 3600.0) == want.predict(T0 + 55 * 3600.0)
    with pytest.raises(ValueError):
        forecast.make_forecaster("arima", HOURS, hist)
    assert scheduler.PersistenceForecaster is forecast.PersistenceForecaster
    assert scheduler.HarmonicForecaster is forecast.HarmonicForecaster
    assert {"best_start_time", "best_source", "OverlayScheduler", "best_ftn",
            "TorchCarbonPlanner", "Plan", "TransferJob", "SLA",
            "CarbonAwareQueue"} <= set(scheduler.__all__)
    assert transfer.migrate_transfer is migrate.migrate_transfer


# (FTNs as (name, profile, max_gbps), threshold, first FTN, size, start):
# tests/test_transfer.py's hand-off and examples/overlay_migration.py's
# download from TACC started on the worst node
MIGRATIONS = {
    "test_transfer": ((("uc", "skylake", 10.0),
                       ("site_qc", "tpu_host", 40.0)),
                      250.0, ("uc", "skylake", 10.0), 1500e9,
                      T0 + 16 * 3600.0),
    "overlay_migration": ((("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
                           ("site_qc", "tpu_host", 40.0)),
                          300.0, ("uc", "skylake", 10.0), 4000e9,
                          T0 + 14 * 3600.0),
}


def _migrate(ov_mod, eng_mod, migrate_fn, case):
    ftns, threshold, first, size, t0 = MIGRATIONS[case]
    ov = ov_mod.OverlayScheduler([ov_mod.FTN(*f) for f in ftns],
                                 threshold=threshold)
    mt = migrate_fn(eng_mod.TransferEngine(), ov, job_uuid="m",
                    source="tacc", first_ftn=ov_mod.FTN(*first),
                    size_bytes=size, t0=t0)
    return mt, ov


@pytest.mark.parametrize("case", sorted(MIGRATIONS))
def test_migrate_transfer_matches_reference(case):
    ref.fresh_default_fields()
    got, ov = _migrate(overlay, engine, transfer.migrate_transfer, case)
    ref.fresh_default_fields()
    want, r_ov = _migrate(r_overlay, r_engine, r_migrate, case)
    assert isinstance(got, MigratedTransfer)
    assert got.ftn_sequence == want.ftn_sequence
    assert got.migrations == want.migrations
    assert dataclasses.astuple(got.final_state) == \
        dataclasses.astuple(want.final_state)
    assert [dataclasses.astuple(s) for s in got.ledger.samples] == \
        [dataclasses.astuple(s) for s in want.ledger.samples]
    assert got.ledger.job_uuid == want.ledger.job_uuid
    assert [dataclasses.astuple(e) for e in ov.events] == \
        [dataclasses.astuple(e) for e in r_ov.events]
    # the transfer completes, never re-sends a byte, and the example's
    # scenario does migrate
    assert got.final_state.finished
    assert got.final_state.bytes_done == pytest.approx(
        MIGRATIONS[case][3])
    bs = [s.bytes_total for s in got.ledger.samples]
    assert all(b2 >= b1 for b1, b2 in zip(bs, bs[1:]))
    assert len(got.ftn_sequence) == got.migrations + 1
    if case == "overlay_migration":
        assert got.migrations >= 1


@pytest.mark.parametrize("src,dst", [("uc", "tacc"), ("tacc", "m1"),
                                     ("site_ca", "site_or"),
                                     ("tacc", "site_or")])
def test_path_power_w_matches_reference(src, dst):
    f, rf = field.CarbonField(), r_field.CarbonField()
    p, rp = discover_path(src, dst), r_discover(src, dst)
    for recv in ("cascade_lake", "apple_m1"):
        for gbps, par, con in ((0.05, 1, 1), (1.2, 4, 2), (8.8, 4, 2),
                               (40.0, 8, 4)):
            got = f.path_power_w(p, HOST_PROFILES["storage_frontend"],
                                 HOST_PROFILES[recv], gbps,
                                 parallelism=par, concurrency=con)
            want = rf.path_power_w(rp, R_HOSTS["storage_frontend"],
                                   R_HOSTS[recv], gbps, parallelism=par,
                                   concurrency=con)
            assert got == want
            w = f._device_weights(p, HOST_PROFILES["storage_frontend"],
                                  HOST_PROFILES[recv], gbps, par, con)
            assert got == pytest.approx(float(np.sum(w)), rel=1e-12)
