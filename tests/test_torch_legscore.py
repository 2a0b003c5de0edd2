"""The per-leg torch scorer behind ``TorchCarbonPlanner(backend="torch")``
against the reference's ``JaxGridScorer`` and the numpy field.

The window view first: ``window_ci`` (numpy) and ``window_ci_torch`` (on
the CPU here) against the reference's ``window_ci`` and the scalar trace
(``tests/test_carbon_field.py``'s case). Then ``TorchGridScorer.
leg_emissions_g`` on ``_torch_ref.LEG_CASES`` (paths of 3 to 11 hops, a
grid across an hour, a day and a weekend boundary, a 672-hour window, a
re-anchor, unaligned starts, zero throughput) against the reference's
scorer, which runs in a child process (on jax >= 0.9 its jax paths load
only there), and against the numpy field: within 1e-4 relative, the same
window anchors. Then ``plan()``, ``plan_batch()`` with
``batch_backend="numpy"`` and ``rescore()`` on the torch backend against
the reference's ``backend="jax"`` and the numpy backend: the same cells,
emissions and cost within 1e-4. And the planner's contract around the
scorer: a pickle drops it, an unknown backend raises, and the time and
index math survives CUDA's division by a Python scalar.
"""
import math
import pickle

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import _torch_ref as ref
from repro.core.carbon import field as r_field
from repro.core.carbon.intensity import REGIONS as R_REGIONS
from repro.core.carbon.intensity import calibrated_ci
from repro_torch.core import carbon
from repro_torch.core.carbon import field
from repro_torch.core.carbon import path as path_mod
from repro_torch.core.carbon.energy import HOST_PROFILES
from repro_torch.core.carbon.intensity import REGIONS
from repro_torch.core.scheduler import grid_torch, overlay, planner

T0 = ref.T0
REL_TOL = 1e-4
SENDER = HOST_PROFILES["storage_frontend"]
RECEIVER = HOST_PROFILES[ref.LEG_RECEIVER]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref.warm_up_torch()
    return ref.run_reference("legs", tmp_path_factory.mktemp("ref") / "l.npz")


def _rel(got, want) -> float:
    """Largest relative difference; an infinite entry must be the same
    infinity on both sides."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    fin = np.isfinite(want)
    if (got[~fin] != want[~fin]).any():
        return math.inf
    return float(np.max(np.abs(got[fin] - want[fin])
                        / np.maximum(np.abs(want[fin]), 1e-12),
                        initial=0.0))


# --- the window view -------------------------------------------------------

def _window_case():
    zones = list(REGIONS)
    zi = np.arange(len(zones))[:, None]
    rel = np.linspace(0.1, 59.6, 41)[None, :] * 3600.0
    return zones, zi, rel


def test_window_ci_matches_reference_and_the_scalar_trace():
    ref.warm_up_torch()
    zones, zi, rel = _window_case()
    assert list(R_REGIONS) == zones
    w = field.make_window(zones, T0, 60)
    rw = r_field.make_window(zones, T0, 60)
    for k in ("base", "amp", "dip", "noise_amp", "peak", "noise"):
        assert np.asarray(getattr(w, k)).tolist() == \
            np.asarray(getattr(rw, k)).tolist()
    assert (w.zones, w.t0, w.hours, w.cal_a, w.cal_b) == \
        (rw.zones, rw.t0, rw.hours, rw.cal_a, rw.cal_b)
    got = field.window_ci(w, zi, rel)
    assert got.tolist() == r_field.window_ci(rw, zi, rel).tolist()
    scalar = np.array([[calibrated_ci(z, T0 + t) for t in rel[0]]
                       for z in zones])
    np.testing.assert_allclose(got, scalar, rtol=1e-6)
    on_cpu = field.window_ci_torch(w, zi, rel, device="cpu")
    assert on_cpu.dtype == torch.float32 and on_cpu.shape == got.shape
    # f32 CI chain, f64 time math: f32 rounding of the value only
    np.testing.assert_allclose(on_cpu.numpy(), scalar, rtol=5e-6)
    moved = field.window_to(w, "cpu")
    assert all(isinstance(getattr(moved, k), torch.Tensor)
               for k in ("base", "noise"))
    assert torch.equal(field.window_ci_torch(moved, zi, rel, device="cpu"),
                       on_cpu)
    uncal = field.window_ci_torch(w, zi, rel, device="cpu", calibrated=False)
    np.testing.assert_allclose(
        uncal.numpy(), field.window_ci(w, zi, rel, calibrated=False),
        rtol=5e-6)
    # outside the window: clamped to its edge hours, as numpy
    far = np.array([[-7200.0, 61 * 3600.0, 400 * 3600.0]])
    np.testing.assert_allclose(
        field.window_ci_torch(w, zi, far, device="cpu").numpy(),
        field.window_ci(w, zi, far), rtol=5e-6)
    assert {"CarbonWindow", "make_window", "window_ci"} <= set(
        carbon.__all__)


# --- the per-leg scorer ----------------------------------------------------

def _port_legs():
    """Every leg case on one port scorer (CPU), in order: emissions,
    window (t0, hours) after the call, and the scorer."""
    sc = grid_torch.TorchGridScorer(device="cpu")
    out = {}
    for name, routes, size, gbps, starts in ref.LEG_CASES:
        p = ref.leg_path(path_mod, routes)
        e = sc.leg_emissions_g(p, SENDER, RECEIVER, size,
                               ref.leg_starts(starts), gbps,
                               parallelism=ref.LEG_PAR,
                               concurrency=ref.LEG_CON)
        pw = sc._windows.get((p.src, p.dst, p.hops))
        out[name] = (e, [pw.t0, pw.hours] if pw is not None
                     else [-1.0, -1.0], p)
    return out, sc


@pytest.fixture(scope="module")
def port_legs():
    ref.warm_up_torch()
    return _port_legs()


@pytest.mark.parametrize("case", [c[0] for c in ref.LEG_CASES])
def test_leg_emissions_match_reference_and_numpy(case, reference,
                                                 port_legs):
    legs, _ = port_legs
    got, window, p = legs[case]
    want = reference[f"legs/{case}"]
    assert got.shape == want.shape
    assert window == reference[f"legs/{case}/window"].tolist()
    spec = {c[0]: c for c in ref.LEG_CASES}[case]
    _, routes, size, gbps, starts = spec
    oracle = field.default_field().transfer_emissions_g(
        p, SENDER, RECEIVER, size, ref.leg_starts(starts), gbps,
        parallelism=ref.LEG_PAR, concurrency=ref.LEG_CON)
    if gbps <= 0:
        assert np.isinf(got).all() and np.isinf(want).all()
        return
    assert np.isfinite(got).all() and (got > 0).all()
    assert _rel(got, want) <= REL_TOL
    assert _rel(got, oracle) <= REL_TOL
    if case == "unaligned":            # the numpy field's own answer
        assert got.tolist() == oracle.tolist()


def test_scorer_counts_windows_legs_and_numpy_legs(port_legs):
    legs, sc = port_legs
    assert [len(legs["h11"][2].hops), len(legs["h3"][2].hops)] == [11, 3]
    assert sorted({len(v[2].hops) for v in legs.values()}) == \
        [3, 4, 5, 6, 8, 11]
    assert sc.numpy_legs == 1
    scored = [c for c in ref.LEG_CASES if c[3] > 0 and c[0] != "unaligned"]
    assert sc.legs == len(scored)
    # six paths, uc->tacc re-anchored twice: a 672-hour window for the
    # long grid, then a new anchor 30 days on
    assert sc.windows_built == 6 + 2
    assert legs["late"][1][0] == T0 + 30 * 86400.0


# --- the planner on the torch backend ---------------------------------------

def _planners(**kw):
    ftns = ref.make_ftns(overlay, ref.SCALE_FTNS)
    return (planner.TorchCarbonPlanner(ftns, backend="torch", device="cpu",
                                       **kw),
            planner.TorchCarbonPlanner(ftns, device="cpu", **kw))


def _same_plans(got, want, tol: float = REL_TOL):
    for k in ("start_t", "source", "ftn", "feasible", "alternatives"):
        assert got[k].tolist() == want[k].tolist(), k
    for k in ("emis", "cost"):
        assert _rel(got[k], want[k]) <= tol, k


@pytest.mark.parametrize("scaled", [False, True])
def test_plan_batch_and_rescore_match_reference_jax_and_numpy(scaled,
                                                              reference):
    ref.warm_up_torch()
    tag = "drift" if scaled else "plain"
    fast, oracle = _planners(batch_backend="numpy")
    for pl in (fast, oracle):
        pl.emission_scale_fn = ref.drift if scaled else None
    job = ref.make_jobs(planner, [ref.LEG_PLAN_JOB])[0]
    got = ref.plan_arrays([fast.plan(job)])
    want = {k[len(f"legplan/{tag}/plan/"):]: v for k, v in reference.items()
            if k.startswith(f"legplan/{tag}/plan/")}
    _same_plans(got, want)
    _same_plans(got, ref.plan_arrays([oracle.plan(job)]))
    jobs = ref.make_jobs(planner, ref.LEG_PLAN_BATCH)
    plans = fast.plan_batch(jobs)
    got = ref.plan_arrays(plans)
    want = {k[len(f"legplan/{tag}/batch/"):]: v for k, v in reference.items()
            if k.startswith(f"legplan/{tag}/batch/")}
    _same_plans(got, want)
    oracle_plans = oracle.plan_batch(jobs)
    _same_plans(got, ref.plan_arrays(oracle_plans))
    assert not plans[-1].feasible      # the all-masked job's fallback
    # re-scores with the hook switched, as the reference's
    for pl in (fast, oracle):
        pl.emission_scale_fn = None if scaled else ref.drift
    re = [fast.rescore(j, p) for j, p in zip(jobs, plans) if p.feasible]
    want = {k[len(f"legplan/{tag}/rescore/"):]: v
            for k, v in reference.items()
            if k.startswith(f"legplan/{tag}/rescore/")}
    _same_plans(ref.plan_arrays(re), want)
    _same_plans(ref.plan_arrays(re), ref.plan_arrays(
        [oracle.rescore(j, p) for j, p in zip(jobs, plans) if p.feasible]))
    assert fast.scorer.legs > 0 and fast.scorer.numpy_legs == 0
    assert oracle.scorer is None


def test_pickle_drops_the_scorer_and_plans_the_same():
    fast, _ = _planners(batch_backend="numpy")
    job = ref.make_jobs(planner, [ref.LEG_PLAN_JOB])[0]
    before = fast.plan(job)
    assert fast.scorer is not None and fast.scorer.windows_built > 0
    back = pickle.loads(pickle.dumps(fast))
    assert back._scorer is None and back.backend == "torch"
    assert back.device == torch.device("cpu")
    after = back.plan(job)
    assert after == before
    assert back.scorer.windows_built == fast.scorer.windows_built


def test_unknown_backend_raises():
    ftns = ref.make_ftns(overlay, ref.SCALE_FTNS)
    with pytest.raises(ValueError, match="backend"):
        planner.TorchCarbonPlanner(ftns, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        planner.TorchCarbonPlanner(ftns, backend="jax", device="cpu")
    assert planner.TorchCarbonPlanner(ftns, device="cpu").backend == "numpy"


# --- CUDA's division by a Python scalar -------------------------------------

class CudaScalarDivision(TorchFunctionMode):
    """A float tensor divided by a Python number as CUDA's kernel does it:
    multiplied by the divisor's reciprocal, which is rounded once in the
    tensor's type. Divisions by a tensor are left as they are."""

    DIVS = {torch.Tensor.__truediv__, torch.Tensor.div, torch.div,
            torch.true_divide, torch.Tensor.true_divide}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in self.DIVS and len(args) == 2
                and isinstance(args[0], torch.Tensor)
                and args[0].is_floating_point()
                and isinstance(args[1], (int, float))
                and kwargs.get("rounding_mode") is None):
            np_t = {torch.float64: np.float64,
                    torch.float32: np.float32}[args[0].dtype]
            return args[0] * float(np_t(1.0) / np_t(args[1]))
        return func(*args, **kwargs)


def _boundary_rel(hours: int, dtype=np.float64) -> np.ndarray:
    """Every hour boundary of a window (so every day boundary), and the
    floats one ulp either side of each, in ``dtype``."""
    b = (3600.0 * np.arange(hours)).astype(dtype)
    lo, hi = dtype(-np.inf), dtype(np.inf)
    return np.unique(np.concatenate(
        [b, np.nextafter(b, lo), np.nextafter(b, hi)]))


def _numpy_rate(f, p, pw, w, rel, wd):
    """The reference scorer's rate on numpy: window CI times the hop band
    at the window-relative hour, weighted (its ``_make_rate_fn`` body)."""
    zci = field.window_ci(w, pw.zone_idx.numpy()[:, None], rel[None, :])
    hour_rel = np.clip(np.floor(rel / 3600.0).astype(np.int64), 0,
                       pw.hours - 1)
    band = (1.0 + 0.02 * np.array([f._hop_band(h.ip) for h in p.hops])
            [:, None] + 0.005 * pw.hop_noise.double().numpy()[:, hour_rel])
    return (wd @ (zci * band)) / 3.6e6


def test_hour_and_day_indices_survive_reciprocal_division():
    """CUDA divides by a Python scalar as a multiplication by its
    reciprocal. The scorer's hour and day indices (time math in f64, true
    divisions) must land where numpy's do at every hour and day boundary
    of a two-week window, and one ulp either side, under that arithmetic:
    the zone and hop noise columns read, hence the CI and the rate, match
    numpy's. In f64 the reciprocals of 3600 and 86400 move no boundary;
    the control shows the probes catch one that does: f32 time math with a
    plain ``/ 3600.0`` floors into another hour than numpy's f32
    division."""
    f = field.default_field()
    p = path_mod.discover_path("uc", "tacc")
    t0 = 3600.0 * math.floor((T0 + 3 * 86400.0 - 7200.0) / 3600.0)
    hours = grid_torch._WINDOW_HOURS
    rel = _boundary_rel(hours)
    pw = grid_torch._PathWindow(f, p, t0, hours, torch.device("cpu"))
    w = field.make_window(pw.window.zones, t0, hours, f)
    zi = np.arange(len(w.zones))[:, None]
    wd = f._device_weights(p, SENDER, RECEIVER, 5.0, 4, 2)
    want_ci = field.window_ci(w, zi, rel[None, :])
    want_r = _numpy_rate(f, p, pw, w, rel, wd)
    rel32 = _boundary_rel(hours, np.float32)
    with CudaScalarDivision():
        got_ci = field.window_ci_torch(w, zi, rel[None, :], device="cpu")
        got_r = grid_torch.leg_rate(pw, torch.as_tensor(wd),
                                    torch.as_tensor(rel))
        naive = torch.floor(torch.as_tensor(rel32) / 3600.0)
    assert _rel(got_ci.numpy(), want_ci) <= 5e-6
    assert _rel(got_r.numpy(), want_r) <= 5e-6
    assert (naive.numpy() != np.floor(rel32 / np.float32(3600.0))).any()
