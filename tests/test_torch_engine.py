"""The transfer engine: the port's ``TransferEngine`` against the
reference's.

The same transfers stepped on both sides give the same ``StepObs``
sequences, congestion draws, ledger samples, Pmeter records and learned
throughput bit for bit; and the port keeps the reference's own engine
contracts (``tests/test_transfer.py``): the step-composed ``run`` against
the scalar ``run_reference``, the pro-rated final step, resumption.
The scalar carbon-field fast paths the controller's accounting reads
(``path_ci_scalar``, ``path_device_rate_scalar``) match the reference's
too.
"""
import dataclasses

import numpy as np
import pytest

import _torch_ref as ref
from repro.core.carbon import field as r_field
from repro.core.carbon import path as r_path
from repro.core.carbon import score as r_score
from repro.core.carbon import telemetry as r_telemetry
from repro.core.carbon.energy import HOST_PROFILES as R_HOSTS
from repro.core.transfer import engine as r_engine
from repro_torch.core.carbon import field, path, score, telemetry
from repro_torch.core.carbon.energy import HOST_PROFILES
from repro_torch.core.transfer import (StepObs, TransferEngine,
                                       TransferState)

T0 = ref.T0
# (src, dst, size, pipelining, dt_s, start offset): a WAN copy, a site
# relay, a transfer without pipelining and a short one mid-step
TRANSFERS = [("uc", "tacc", 250e9, 4, 60.0, 0.0),
             ("site_qc", "tacc", 80e9, 4, 60.0, 1234.5),
             ("uc", "site_ne", 40e9, 1, 30.0, 7.0),
             ("m1", "tacc", 3e9, 4, 60.0, 59.0)]


def _pair(dt_s):
    return TransferEngine(dt_s=dt_s), r_engine.TransferEngine(dt_s=dt_s)


@pytest.mark.parametrize("src,dst,size,pipelining,dt_s,off", TRANSFERS)
def test_step_sequences_are_the_references(src, dst, size, pipelining,
                                           dt_s, off):
    eng, reng = _pair(dt_s)
    states = [e.start("t", src, dst, size, T0 + off, parallelism=8,
                      pipelining=pipelining) for e in (eng, reng)]
    seqs = ([], [])
    for _ in range(100000):
        for e, st, seq in zip((eng, reng), states, seqs):
            seq.append(dataclasses.astuple(e.step(st)))
        if states[0].finished and states[1].finished:
            break
    assert seqs[0] == seqs[1] and seqs[0][-1][-1] is True
    assert dataclasses.astuple(states[0]) == dataclasses.astuple(states[1])
    assert eng.model.history == reng.model.history
    # a finished transfer steps as a no-op on both sides
    assert dataclasses.astuple(eng.step(states[0])) == \
        dataclasses.astuple(reng.step(states[1]))
    # the congestion trace is the reference's draw for draw
    for k in range(-5, 400, 7):
        t = T0 + off + k * dt_s
        assert eng._congestion(states[0], t) == \
            reng._congestion(states[1], t) == \
            eng._congestion_reference(states[0], t, dt_s)


def test_run_records_the_references_ledger_and_pmeters():
    eng, reng = _pair(60.0)
    out = []
    for e, sc, tel in ((eng, score, telemetry),
                       (reng, r_score, r_telemetry)):
        led = sc.TransferLedger("r")
        pms = (tel.Pmeter("uc", "skylake", clock=lambda: T0),
               tel.Pmeter("tacc", "cascade_lake", zone="US-TEX-ERCO"))
        st = e.start("r", "uc", "tacc", 120e9, T0, parallelism=4)
        st = e.run(st, until=T0 + 900.0, ledger=led, pmeter_src=pms[0],
                   pmeter_dst=pms[1])
        token = st.checkpoint()
        st2 = e.start("r", "uc", "site_qc", 120e9, st.t_now, resume=token)
        st2 = e.run(st2, ledger=led)
        out.append((dataclasses.astuple(st), dataclasses.astuple(st2),
                    [dataclasses.astuple(s) for s in led.samples],
                    [r.to_json() for p in pms for r in p.records],
                    pms[1].emissions_g(), e.model.history, led.score()))
    assert out[0] == out[1]
    assert out[0][2] and out[0][3]


def test_step_composed_run_matches_the_scalar_oracle():
    """tests/test_transfer.py's contract, on the port: ``run`` (a loop of
    ``step`` on the field's noise table) against ``run_reference``."""
    eng_a, eng_b = TransferEngine(), TransferEngine()
    led_a, led_b = score.TransferLedger("a"), score.TransferLedger("b")
    st_a = eng_a.run(eng_a.start("a", "uc", "tacc", 250e9, T0), ledger=led_a)
    st_b = eng_b.run_reference(eng_b.start("b", "uc", "tacc", 250e9, T0),
                               ledger=led_b)
    assert st_a.finished and st_b.finished
    assert st_a.t_now == pytest.approx(st_b.t_now, abs=1e-6)
    assert len(led_a.samples) == len(led_b.samples)
    for sa, sb in zip(led_a.samples, led_b.samples):
        assert sa.t == pytest.approx(sb.t, abs=1e-6)
        assert sa.throughput_gbps == pytest.approx(sb.throughput_gbps)
        assert sa.ci == pytest.approx(sb.ci, rel=1e-9)
    assert eng_a.model.history[-1][-1] == pytest.approx(
        eng_b.model.history[-1][-1], rel=1e-9)


def test_final_step_is_prorated_and_resume_excludes_prior_bytes():
    eng = TransferEngine(dt_s=60.0)
    st = eng.run(eng.start("p", "uc", "tacc", 100e9, T0))
    elapsed = st.t_now - st.t_started
    assert 0 < elapsed - int(elapsed // 60.0) * 60.0 < 60.0
    assert eng.model.history[-1][-1] == pytest.approx(
        100e9 * 8.0 / 1e9 / elapsed, rel=1e-12)
    obs = eng.step(st)
    assert isinstance(obs, StepObs) and obs.finished and obs.step_s == 0.0

    eng = TransferEngine()
    st = eng.run(eng.start("r", "uc", "tacc", 300e9, T0), until=T0 + 120.0)
    assert isinstance(st, TransferState) and not st.finished
    token = st.checkpoint()
    st2 = eng.run(eng.start("r", "uc", "site_qc", 300e9, st.t_now,
                            resume=token))
    moved = (300e9 - token["offset"]) * 8.0 / 1e9
    assert eng.model.history[-1][-1] == pytest.approx(
        moved / (st2.t_now - st2.t_started), rel=1e-12)
    eng = TransferEngine()
    assert eng.run(eng.start("q", "uc", "tacc", 50e9, T0,
                             observe=False)).finished
    assert not eng.model.history


@pytest.mark.parametrize("src,dst", [("uc", "tacc"), ("site_qc", "tacc"),
                                     ("tacc", "site_or")])
def test_scalar_field_paths_are_the_references(src, dst):
    f, rf = field.CarbonField(), r_field.CarbonField()
    p, rp = path.discover_path(src, dst), r_path.discover_path(src, dst)
    scale = {"CA-QC": 6.0}.get
    w = f.device_weight_fn(p, HOST_PROFILES["storage_frontend"],
                           HOST_PROFILES["cascade_lake"], 4, 2)(7.5)
    rw = rf.device_weight_fn(rp, R_HOSTS["storage_frontend"],
                             R_HOSTS["cascade_lake"], 4, 2)(7.5)
    assert np.array_equal(w, rw)
    for t in T0 + np.array([0.0, 59.5, 3600.0, 86400.0 * 5 + 13.0]):
        zs = lambda z: scale(z, 1.0)
        assert f.path_ci_scalar(p, t) == rf.path_ci_scalar(rp, t)
        assert f.path_ci_scalar(p, t, zs) == rf.path_ci_scalar(rp, t, zs)
        assert f.path_device_rate_scalar(p, w, t, zs) == \
            rf.path_device_rate_scalar(rp, rw, t, zs)
        assert f.path_ci_scalar(p, t) == pytest.approx(
            float(f.path_ci(p, t)), rel=1e-12)
        assert f.path_device_rate_scalar(p, w, t) == pytest.approx(
            float(w @ f.hop_ci_matrix(p, [t])[:, 0]), rel=1e-12)
