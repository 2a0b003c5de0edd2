"""The port's copies of the jax-free carbon modules give the reference's
values bit for bit, on seeded times and paths."""
import numpy as np
import pytest

from repro.core.carbon import energy as r_energy
from repro.core.carbon import field as r_field
from repro.core.carbon import intensity as r_intensity
from repro.core.carbon import path as r_path
from repro.core.carbon import score as r_score
from repro.core.transfer import throughput as r_throughput
from repro_torch.core.carbon import energy as t_energy
from repro_torch.core.carbon import field as t_field
from repro_torch.core.carbon import intensity as t_intensity
from repro_torch.core.carbon import path as t_path
from repro_torch.core.carbon import score as t_score
from repro_torch.core.scheduler import time_shift as t_time_shift
from repro_torch.core.transfer import throughput as t_throughput

T0 = r_intensity.PAPER_WINDOW_T0
ROUTES = [("uc", "tacc"), ("m1", "tacc"), ("uc", "m1"), ("m1", "uc"),
          ("uc", "uc"), ("site_qc", "site_de"), ("site_ca", "site_ne")]


def _times(seed: int, n: int = 400) -> np.ndarray:
    """Seeded times over three weeks around the paper window, hour and
    day boundaries included."""
    rng = np.random.default_rng(seed)
    ts = T0 + rng.uniform(-7 * 86400.0, 14 * 86400.0, n)
    edges = T0 + 3600.0 * np.arange(-3, 60)
    return np.concatenate([ts, edges, edges - 1e-6])


def test_calibration_and_constants_match():
    assert t_intensity.get_calibration() == r_intensity.get_calibration()
    assert t_intensity.PAPER_WINDOW_T0 == T0
    assert sorted(t_intensity.REGIONS) == sorted(r_intensity.REGIONS)
    for z, reg in r_intensity.REGIONS.items():
        assert t_intensity.REGIONS[z] == t_intensity.GridRegion(
            **vars(reg))
    for name, prof in r_energy.HOST_PROFILES.items():
        assert vars(t_energy.HOST_PROFILES[name]) == vars(prof)


@pytest.mark.parametrize("zone", sorted(r_intensity.REGIONS))
def test_zone_ci_bit_equal(zone):
    ts = _times(sorted(r_intensity.REGIONS).index(zone))
    want = r_field.CarbonField().zone_ci(zone, ts)
    got = t_field.CarbonField().zone_ci(zone, ts)
    assert np.array_equal(got, want)
    t = float(ts[3])
    assert t_intensity.calibrated_ci(zone, t) == \
        r_intensity.calibrated_ci(zone, t)


@pytest.mark.parametrize("route", ROUTES, ids="-".join)
def test_paths_and_hop_ci_bit_equal(route):
    rp, tp = r_path.discover_path(*route), t_path.discover_path(*route)
    assert [(h.ip, h.zone, h.rtt_ms) for h in tp.hops] == \
        [(h.ip, h.zone, h.rtt_ms) for h in rp.hops]
    ts = _times(7)
    rf, tf = r_field.CarbonField(), t_field.CarbonField()
    assert np.array_equal(tf.hop_ci_matrix(tp, ts), rf.hop_ci_matrix(rp, ts))
    assert np.array_equal(tf.path_ci(tp, ts), rf.path_ci(rp, ts))
    assert np.array_equal(tf.expected_transfer_ci(tp, ts[:50], 5400.0),
                          rf.expected_transfer_ci(rp, ts[:50], 5400.0))
    assert t_time_shift.expected_transfer_ci(tp, T0 + 600.0, 5400.0) == \
        pytest.approx(tf.expected_transfer_ci(tp, T0 + 600.0, 5400.0)[0],
                      rel=1e-12)


@pytest.mark.parametrize("route", ROUTES, ids="-".join)
def test_device_weights_and_emissions_bit_equal(route):
    rng = np.random.default_rng(11)
    rp, tp = r_path.discover_path(*route), t_path.discover_path(*route)
    rf, tf = r_field.CarbonField(), t_field.CarbonField()
    rs, rr = (r_energy.HOST_PROFILES["storage_frontend"],
              r_energy.HOST_PROFILES["cascade_lake"])
    ts_, tr = (t_energy.HOST_PROFILES["storage_frontend"],
               t_energy.HOST_PROFILES["cascade_lake"])
    gbps = rng.uniform(0.2, 40.0, 16)
    assert np.array_equal(tf.device_weight_fn(tp, ts_, tr, 4, 2)(gbps),
                          rf.device_weight_fn(rp, rs, rr, 4, 2)(gbps))
    aligned = T0 + 3600.0 * np.arange(30) + 60.0 * rng.integers(0, 60)
    unaligned = T0 + rng.uniform(0, 86400.0, 7)
    for starts in (aligned, unaligned):
        for g in gbps[:3]:
            want = rf.transfer_emissions_g(rp, rs, rr, 123e9, starts, g,
                                           parallelism=4, concurrency=2)
            got = tf.transfer_emissions_g(tp, ts_, tr, 123e9, starts, g,
                                          parallelism=4, concurrency=2)
            assert np.array_equal(got, want)
    t = float(aligned[5])
    assert t_score.transfer_emissions_g_reference(tp, ts_, tr, 40e9, t, 9.5) \
        == r_score.transfer_emissions_g_reference(rp, rs, rr, 40e9, t, 9.5)
    assert t_score.carbonscore(1e9, 300.0, 80.0) == \
        r_score.carbonscore(1e9, 300.0, 80.0)


def test_throughput_model_bit_equal():
    rm, tm = r_throughput.ThroughputModel(), t_throughput.ThroughputModel()
    for a, b in ROUTES:
        for par, con in ((1, 1), (4, 2), (8, 4)):
            assert tm.predict(a, b, par, con) == rm.predict(a, b, par, con)
