"""Shared inputs for the port's tests, and the reference run that feeds them.

The port (``repro_torch``) is held against the JAX package (``repro``).
On jax >= 0.9 the reference's jax and Pallas planner paths do not import
(``from jax.experimental import enable_x64`` is gone), and nothing in the
reference may change. So the reference runs in a child process that first
sets ``jax.experimental.enable_x64 = jax.enable_x64``, drives the
reference's own planner on the cases below, and writes what its kernels
saw and returned to an ``.npz`` file. The alias lives and dies with that
process: the test process never sees it.

    python tests/_torch_ref.py OUT.npz grid|fused|planner|legs|split|moe_ep|
        seq_attn|seq_models|layout|cost|cost_kernel_{attention,ssm}|dryrun|
        dryrun_kernel|remat

The mesh cases (``split``, ``moe_ep``, ``seq_attn``, ``seq_models``,
``layout``, ``cost``, ``dryrun``) run the reference's sharded paths on a forced host-device count
(``run_reference(..., host_devices=n)``), set in ``XLA_FLAGS`` before the
child imports jax.

Cases are plain data, built into jobs by :func:`make_jobs` against either
package's planner module, so both implementations plan identical inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

REPO = Path(__file__).resolve().parents[1]
T0 = 1713052800.0                      # PAPER_WINDOW_T0 of both packages
DT_S, SLOT_S, STRIDE = 60.0, 3600.0, 60

# the planner_scale deployment's FTNs (benchmarks/perf.py) and, for the
# edge cases, tests/test_grid_pallas.py's
SCALE_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
              ("tacc", "cascade_lake", 10.0))
EDGE_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
             ("site_qc", "cascade_lake", 40.0),
             ("tacc", "cascade_lake", 10.0))

# (uuid, size_bytes, replicas, dst, deadline_s, carbon_budget_g, submit)
EDGE_CASES: Dict[str, List[tuple]] = {
    "zero_cells": [],
    "single_slot": [(f"ss{i}", 30e9, ("uc",), "tacc", 3700.0 + i * 10.0,
                     None, T0 + i * 13.0) for i in range(3)],
    "all_masked": [("late", 2000e9, ("uc", "m1"), "tacc", 60.0, None, T0)],
    "one_step_clamp": [(f"tiny{i}", 1e9 + i * 2e8, ("uc", "m1"), "tacc",
                        6 * 3600.0, None, T0 + i * 950.0) for i in range(4)],
    "carbon_budget": [(f"bg{i}", (100 + 40 * i) * 1e9, ("uc", "m1"), "tacc",
                       24 * 3600.0, None if i % 2 else 90.0,
                       T0 + i * 1700.0) for i in range(8)],
}


def scale_spec(i: int) -> tuple:
    """planner_scale's job generator (benchmarks/perf.py::planner_scale)."""
    return (f"s{i}", (20 + (13 * i) % 600) * 1e9,
            ("uc", "m1") if i % 3 else ("uc",), "tacc",
            (12 + i % 36) * 3600.0, None, T0 + (i % 288) * 300.0)


def scale_ids(n_anchors: int, per_anchor: int) -> List[int]:
    """planner_scale job ids sharing ``n_anchors`` submission times (ids
    288 apart share one), so a small batch stays within one or two
    chunks."""
    return [j + 288 * m for m in range(per_anchor) for j in range(n_anchors)]


SCALE_CASES: Dict[str, List[tuple]] = {
    "grid": [scale_spec(i) for i in scale_ids(4, 4)],
    "drift": [scale_spec(i) for i in scale_ids(4, 2)],
    "planner": [scale_spec(i) for i in scale_ids(8, 8)],
}


@contextlib.contextmanager
def deadline(seconds: int):
    """Raise ``TimeoutError`` in the main thread if the block runs past
    ``seconds``: a case that starts worker processes bounds itself, so a
    hung worker fails that case instead of holding the whole run."""
    def expired(signum, frame):
        raise TimeoutError(f"case ran past its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def on_another_device(t, device: str = "xpu"):
    """A tensor of ``t``'s shape and dtype on a device the port's kernel
    wrappers do not run on (no storage; any op on it raises)."""
    import torch

    class Elsewhere(torch.Tensor):
        @staticmethod
        def __new__(cls):
            return torch.Tensor._make_wrapper_subclass(
                cls, t.shape, dtype=t.dtype, device=torch.device(device))

        @classmethod
        def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
            raise RuntimeError(f"{func} ran on {device}")

    return Elsewhere()


def warm_up_torch() -> None:
    """Run torch's vectorized math once, multi-threaded, before any test
    compares numbers. With torch 2.13's CPU build, the first parallel
    call of a transcendental op in a process can return low-accuracy
    values (about 1.5e-4 off for cos) on one worker thread's share of
    the tensor; every later call is exact and repeatable."""
    import torch
    w = torch.linspace(-3.0, 3.0, 1 << 21, dtype=torch.float64)
    torch.exp(w)
    torch.cos(w.float())


def fresh_default_fields() -> None:
    """Drop both packages' process-wide default carbon field, so the next
    ``default_field()`` on either side starts cold. A warm field answers
    from the hop-CI prefix-sum grids it cached for earlier windows, and
    those can differ from a cold field's in the last bit; a comparison of
    port and reference must start both from the same state, whatever ran
    before it in the process."""
    from repro.core.carbon import field as r_field
    from repro_torch.core.carbon import field as t_field
    for mod in (r_field, t_field):
        mod._DEFAULT, mod._DEFAULT_PID = None, None


def make_jobs(planner_mod, specs) -> list:
    return [planner_mod.TransferJob(u, size, reps, dst,
                                    planner_mod.SLA(deadline_s=dl,
                                                    carbon_budget_g=bg),
                                    sub)
            for u, size, reps, dst, dl, bg, sub in specs]


def make_ftns(overlay_mod, specs) -> list:
    return [overlay_mod.FTN(*s) for s in specs]


def drift(path, ts):
    """A deterministic emission_scale_fn: works on either package's
    paths (it reads only the hop count and the times)."""
    return 1.0 + 0.1 * np.sin(np.asarray(ts) / 7200.0 + path.n_hops)


# --- the per-leg scorer (tests/test_torch_legscore.py) ----------------------
# Legs scored one after another on one scorer, so later legs reuse or
# re-anchor earlier windows: (name, routes, size_bytes, gbps, starts) with
# routes a tuple of (src, dst) whose hops are joined (the 11-hop path is
# uc->tacc's 8 and three transit hops of tacc->site_or) and starts
# (first offset from T0 s, spacing s, count). "boundary" crosses an hour,
# a day and a weekday/weekend boundary (T0 + 3 d starts day-of-week 5);
# "long_grid" needs a 672-hour window; "late" re-anchors uc->tacc 30
# days on; "unaligned" starts off a common 60 s grid go to the numpy field.
LEG_CASES = (
    ("h3", (("site_ca", "site_or"),), 300e9, 5.0, (0.0, 3600.0, 12)),
    ("h4", (("uc", "m1"),), 120e9, 1.2, (1800.0, 3600.0, 6)),
    ("h5", (("tacc", "site_or"),), 300e9, 9.0, (0.0, 3600.0, 24)),
    ("h6", (("tacc", "m1"),), 40e9, 1.0, (600.0, 3600.0, 3)),
    ("h8", (("uc", "tacc"),), 300e9, 5.0, (0.0, 3600.0, 48)),
    ("h11", (("uc", "tacc"), ("tacc", "site_or")), 500e9, 7.5,
     (0.0, 3600.0, 20)),
    ("boundary", (("uc", "tacc"),), 2000e9, 5.0,
     (3 * 86400.0 - 5400.0, 600.0, 16)),
    ("long_grid", (("uc", "tacc"),), 30e12, 0.2, (0.0, 3600.0, 24)),
    ("late", (("uc", "tacc"),), 300e9, 5.0, (30 * 86400.0, 3600.0, 12)),
    ("unaligned", (("uc", "tacc"),), 300e9, 5.0, (0.0, 1000.5, 3)),
    ("single", (("tacc", "m1"),), 7e9, 2.5, (86400.0 - 60.0, 3600.0, 1)),
    ("zero_gbps", (("uc", "tacc"),), 300e9, 0.0, (0.0, 3600.0, 4)),
)
LEG_RECEIVER = "cascade_lake"
LEG_PAR, LEG_CON = 4, 2


def leg_path(path_mod, routes):
    """One route's path, or several routes' hops joined (each later
    route's three hops after its source), from either package."""
    first = path_mod.discover_path(*routes[0])
    hops = tuple(first.hops)
    for src, dst in routes[1:]:
        hops += tuple(path_mod.discover_path(src, dst).hops[1:4])
    return path_mod.NetworkPath(first.src, routes[-1][1], hops)


def leg_starts(starts) -> np.ndarray:
    off, step, n = starts
    return T0 + off + step * np.arange(n)


# tests/test_controlplane.py's per-leg backend cases (the planner_scan job,
# four jobs at half-hour submissions) and the edge cases with carbon
# budgets and an all-infeasible job, planned with the per-leg scorer
LEG_PLAN_JOB = ("jx", 300e9, ("uc", "m1"), "tacc", 48 * 3600.0, None, T0)
LEG_PLAN_BATCH = ([(f"jb{i}", (50 + 70 * i) * 1e9, ("uc",), "tacc",
                    24 * 3600.0, None, T0 + i * 1800.0) for i in range(4)]
                  + EDGE_CASES["carbon_budget"] + EDGE_CASES["all_masked"])


# --- the fleet control plane ------------------------------------------------
# tests/test_controlplane.py's, tests/test_sharded.py's and tests/test_obs.py's
# fleets: FTNs, and job specs as (uuid, size_bytes, replicas, deadline_s,
# submit) to "tacc"
FLEET_FTNS = (("uc", "skylake", 10.0), ("m1", "apple_m1", 1.2),
              ("site_qc", "cascade_lake", 40.0),
              ("tacc", "cascade_lake", 10.0))
SHOCK_ZONES = ("CA-QC", "US-NY-NYIS")


def heavy_specs(n: int = 12, t_off_h: float = 10.0,
                deadline_h: float = 24.0) -> List[tuple]:
    """test_controlplane's ``_heavy``: 2 TB archival copies from uc."""
    return [(f"h{i}", 2000e9 + i * 1e9, ("uc",), deadline_h * 3600.0,
             T0 + t_off_h * 3600.0 + i * 600.0) for i in range(n)]


def sharded_specs(n: int = 12) -> List[tuple]:
    """test_sharded's ``_jobs``."""
    return [(f"s{i}", (300 + 100 * i) * 1e9,
             ("uc", "site_ne") if i % 2 else ("uc",),
             (8 + i % 6) * 3600.0, T0 + i * 1200.0) for i in range(n)]


def obs_specs(n: int = 18, spread_s: float = 1200.0) -> List[tuple]:
    """test_obs's ``_jobs``."""
    return [(f"o{i}", (300 + 53 * i % 1500) * 1e9,
             ("uc", "site_ne") if i % 2 else ("uc",),
             (8 + i % 6) * 3600.0, T0 + i * spread_s) for i in range(n)]


def fleet_jobs(planner_mod, specs) -> list:
    return [planner_mod.TransferJob(u, size, reps, "tacc",
                                    planner_mod.SLA(deadline_s=dl), sub)
            for u, size, reps, dl, sub in specs]


def shock(fleet, at_h: float = 5.0, hours: float = 5.0) -> None:
    fleet.inject_shock(T0 + at_h * 3600.0, 6.0, duration_s=hours * 3600.0,
                       zones=SHOCK_ZONES)


def no_wall(snap) -> dict:
    """test_obs's ``_no_wall``: a metrics snapshot minus its wall-clock
    series."""
    return {kind: [e for e in snap.get(kind, ()) if "wall" not in e["name"]]
            for kind in ("counters", "gauges", "histograms")}


def report_fields(rep, ignore=("wall_s", "jobs_per_s", "metrics")) -> dict:
    """A FleetReport as plain data, comparable across the two packages
    (their dataclasses never compare equal to each other): outcome rows as
    tuples, spans as tuples; ``metrics`` without its wall series."""
    out = {}
    for f in dataclasses.fields(rep):
        if f.name in ignore:
            continue
        v = getattr(rep, f.name)
        if f.name == "outcomes":
            v = [dataclasses.astuple(o) for o in v]
        elif f.name == "trace":
            v = [tuple(sp) for sp in v]
        out[f.name] = v
    if "metrics" not in ignore:
        out["metrics"] = None if rep.metrics is None \
            else no_wall(rep.metrics)
    return out


def assert_reports_identical(got, want, **kw) -> None:
    """Bit-identical FleetReports field by field (test_obs's
    ``_assert_identical``), metrics compared without their wall series."""
    a, b = report_fields(got, **kw), report_fields(want, **kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


OUTCOME_ROW = ("job_uuid", "source", "ftn_sequence", "start_t",
               "migrations", "replanned", "sla_miss", "feasible")
COUNTERS = ("n_jobs", "n_completed", "migrations", "replan_events",
            "plans_changed", "sla_misses", "n_events", "n_steps")


def assert_same_decisions(got, want, rel: float = 1e-4) -> None:
    """The kernel backends against the numpy oracle: every job the same
    outcome row (cell, FTN sequence, migrations, re-plan, SLA miss), the
    same counters, emissions within ``rel``."""
    import pytest
    assert [tuple(getattr(o, k) for k in OUTCOME_ROW) for o in got.outcomes] \
        == [tuple(getattr(o, k) for k in OUTCOME_ROW) for o in want.outcomes]
    assert [getattr(got, k) for k in COUNTERS] == \
        [getattr(want, k) for k in COUNTERS]
    for g, w in zip(got.outcomes, want.outcomes):
        assert g.planned_emissions_g == pytest.approx(w.planned_emissions_g,
                                                      rel=rel)
        assert g.actual_emissions_g == pytest.approx(w.actual_emissions_g,
                                                     rel=rel)
    for k in ("total_planned_g", "total_actual_g", "ledger_total_g"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=rel)


# --- the model families ------------------------------------------------------
# Logits of the port against the reference's, relative to max |logit|. f32:
# sum order and XLA-vs-torch transcendental ulps. bf16: the two frameworks
# round activations to bf16 at different places (XLA fuses elementwise
# chains in f32, torch rounds after each op), ~2^-9 relative at each of a
# few dozen points in 4 layers (tests/test_torch_serving.py).
LOGIT_F32_TOL, LOGIT_BF16_TOL = 1e-4, 2e-2


def model_pair(arch: str, dtype: str, layers: int = 4):
    """The reference's reduced config and ``init_params`` weights (seed 0),
    and the port's config and the same weights as a state dict on the
    CPU: ``(cfg_r, params, cfg_t, state)``."""
    import jax
    from repro.configs import get_reduced as ref_reduced
    from repro.models import init_params
    from repro_torch.configs import get_reduced
    from repro_torch.models.convert import params_from_jax
    cfg_r = dataclasses.replace(ref_reduced(arch, layers=layers), dtype=dtype)
    cfg_t = dataclasses.replace(get_reduced(arch, layers=layers), dtype=dtype)
    params = init_params(jax.random.PRNGKey(0), cfg_r)
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                            device="cpu")
    return cfg_r, params, cfg_t, state


def logit_rel(got, want) -> float:
    """max |got - want| / max |want|, either side numpy, jax or torch."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def frontend_arrays(cfg, batch: int, seq_len: int, seed: int) -> dict:
    """An ``encdec``'s frames [B, S//4, d] or a ``vlm``'s patches [B, P, d]
    as f32 numpy normals times 0.02 (the reference's make_batch scale)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        n = seq_len // 4
        return {"frames": (rng.standard_normal((batch, n, cfg.d_model))
                           * 0.02).astype(np.float32)}
    if cfg.family == "vlm":
        n = cfg.n_frontend_tokens
        return {"patches": (rng.standard_normal((batch, n, cfg.d_model))
                            * 0.02).astype(np.float32)}
    return {}


def prefill_both(pair, ref_impl: str, port_impl: str, tokens: np.ndarray,
                 s_max: int, extra: dict):
    """The reference's jitted prefill and the port's on the same tokens
    and frontend arrays: ``(logits_r, cache_r, logits_t, cache_t)``."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.base import RunConfig as RefRun
    from repro.models import prefill as ref_prefill
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    cfg_r, params, cfg_t, state = pair
    run_r = RefRun(arch=cfg_r.name, attn_impl=ref_impl, remat="none")
    run_t = RunConfig(arch=cfg_t.name, attn_impl=port_impl, remat="none")
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    lj, cj = jax.jit(lambda p, b: ref_prefill(p, cfg_r, run_r, b,
                                              s_max=s_max))(params, batch)
    model = M.Transformer(cfg_t, state)
    lt, ct = M.prefill(model, run_t, torch.as_tensor(tokens), s_max,
                       **{k: torch.as_tensor(v) for k, v in extra.items()})
    return lj, cj, lt, ct


def prefill_decode_errors(pair, ref_impl: str, port_impl: str,
                          tokens: np.ndarray, n_decode: int,
                          extra: dict) -> List[float]:
    """Per step (prefill, then each decode step) the port's relative logit
    error against the reference's; decode feeds the reference's argmax to
    both, from position P + S on (P frontend positions of a ``vlm``)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.base import RunConfig as RefRun
    from repro.models import decode_step as ref_decode
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    cfg_r, params, cfg_t, state = pair
    start = tokens.shape[1] + (cfg_t.n_frontend_tokens
                               if "patches" in extra else 0)
    lj, cj, lt, ct = prefill_both(pair, ref_impl, port_impl, tokens,
                                  start + n_decode + 2, extra)
    model = M.Transformer(cfg_t, state)
    run_r = RefRun(arch=cfg_r.name, attn_impl=ref_impl, remat="none")
    run_t = RunConfig(arch=cfg_t.name, attn_impl=port_impl, remat="none")
    dec = jax.jit(lambda p, t, c, cur: ref_decode(p, cfg_r, run_r, t, c,
                                                  cur))
    errs = [logit_rel(lt.numpy(), lj)]
    tok = np.array(jnp.argmax(lj, -1))[:, None]
    for i in range(n_decode):
        lj, cj = dec(params, jnp.asarray(tok, jnp.int32), cj,
                     jnp.asarray(start + i, jnp.int32))
        lt, ct = M.decode_step(model, run_t, torch.as_tensor(tok), ct,
                               start + i)
        errs.append(logit_rel(lt.numpy(), lj))
        tok = np.array(jnp.argmax(lj, -1))[:, None]
    return errs


def serve_both(pair, prompts: np.ndarray, *, batch: int, max_new: int,
               ref_impl: str = "pallas") -> list:
    """Both ``Server`` loops on the same weights and prompts (port on the
    CPU at ``flash``): per epoch ``(want, got)`` as (rid, tokens, site)
    lists, until the queue is empty."""
    import jax.numpy as jnp
    import torch
    from repro.configs.base import RunConfig as RefRun
    from repro.runtime import serve_loop as ref_serve
    from repro_torch.configs.base import RunConfig
    from repro_torch.runtime import serve_loop
    cfg_r, _, cfg_t, state = pair
    s_max = prompts.shape[1] + max_new
    ref = ref_serve.Server(cfg_r, RefRun(arch="s", attn_impl=ref_impl,
                                         remat="none"),
                           batch=batch, s_max=s_max)
    port = serve_loop.Server(cfg_t, RunConfig(arch="s", attn_impl="flash",
                                              remat="none"),
                             batch=batch, s_max=s_max, device="cpu",
                             params=state)
    for i, p in enumerate(prompts):
        ref.submit(ref_serve.Request(rid=i, prompt=jnp.asarray(p, jnp.int32),
                                     max_new_tokens=max_new))
        port.submit(serve_loop.Request(rid=i, prompt=torch.as_tensor(p),
                                       max_new_tokens=max_new))
    epochs = []
    while ref.queue:
        want, got = ref.step_epoch(), port.step_epoch()
        assert all(c.emissions_mg > 0 and c.latency_s > 0 for c in got)
        epochs.append(([(c.rid, c.tokens, c.site) for c in want],
                       [(c.rid, c.tokens, c.site) for c in got]))
    assert not port.queue and len(port.completions) == len(prompts)
    return epochs


def loss_and_grads_both(pair, ref_impl: str, port_impl: str, batch: dict,
                        xent_chunk: int = 0):
    """``loss_fn`` and the gradient of every parameter under per-layer
    checkpointing: the reference through ``jax.value_and_grad``, the port
    through autograd. Returns (loss_r, loss_t, {state key: relative
    error of the port's gradient against the reference's})."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.base import RunConfig as RefRun
    from repro.models import loss_fn as ref_loss
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_jax
    cfg_r, params, cfg_t, state = pair
    run_r = RefRun(arch=cfg_r.name, attn_impl=ref_impl, remat="block")
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(p, cfg_r, run_r,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           xent_chunk=xent_chunk), has_aux=True))(params)
    model = M.Transformer(cfg_t, {k: v.clone() for k, v in state.items()})
    model.requires_grad_(True)
    lt, _ = M.loss_fn(model, RunConfig(arch=cfg_t.name, attn_impl=port_impl,
                                       remat="block"),
                      {k: torch.as_tensor(v) for k, v in batch.items()},
                      xent_chunk=xent_chunk)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(lt, [p for _, p in model.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, gj), cfg_t, device="cpu")
    assert set(names) == set(want)
    errs = {n: float((g.float() - want[n].float()).abs().max()
                     / want[n].float().abs().max().clamp_min(1e-30))
            for n, g in zip(names, grads)}
    return float(lj), float(lt.detach()), errs


# --- the mesh paths (tests/test_torch_cell_split.py, test_torch_moe_ep.py) --
SPLIT_DEVICES = 3                      # does not divide the 64-cell bucket
MOE_EP_DEVICES = 4
MOE_EP_D, MOE_EP_F, MOE_EP_EXPERTS, MOE_EP_TOP_K = 16, 32, 8, 2
MOE_EP_AUX_W = 0.5                     # aux's weight in the cases' loss
# (name, (data, model) mesh, B, S, gated, shared experts, dense residual,
# capacity factor): at factor 0.5 a token shard's capacity is 8 slots
# where the global dispatch's is 16, so the shards drop assignments the
# global dispatch keeps; T = 63 does not split over 2 data ranks, so
# every rank sees all tokens.
MOE_EP_CASES = (
    ("2x2_drops", (2, 2), 4, 32, True, 0, False, 0.5),
    ("1x4_shared", (1, 4), 4, 32, True, 1, False, 0.5),
    ("4x1_ungated_dense", (4, 1), 4, 32, False, 0, True, 0.5),
    ("2x1_odd_tokens_shared_dense", (2, 1), 1, 63, True, 1, True, 1.0),
)


def moe_ep_inputs(case) -> Dict[str, np.ndarray]:
    """One MoE case's f32 weights in the reference's layout, its input x
    [B, S, d] and the loss's cotangent for y, drawn from a seed."""
    name, _, B, S, gated, n_shared, dense, _ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    d, f, E = MOE_EP_D, MOE_EP_F, MOE_EP_EXPERTS

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = {"router": w(d, E, scale=1.0), "wu": w(E, d, f), "wd": w(E, f, d)}
    if gated:
        out["wg"] = w(E, d, f)
    for pre, width in (("shared", f * n_shared), ("dense", 24 if dense
                                                   else 0)):
        if width:
            out.update({f"{pre}_wu": w(d, width), f"{pre}_wd": w(width, d)})
            if gated:
                out[f"{pre}_wg"] = w(d, width)
    out["x"] = w(B, S, d, scale=1.0)
    out["cot"] = w(B, S, d, scale=1.0)
    return out


def run_reference(what: str, out: Path, timeout: float = 240.0,
                  host_devices: int = 1) -> Dict[str, np.ndarray]:
    """Run this file as the reference child process, with jax forced to
    ``host_devices`` CPU devices; return its arrays."""
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                         f"{host_devices}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out), what],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    if proc.returncode != 0:
        raise RuntimeError(f"reference run {what!r} failed:\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def ref_tables(arrs: Dict[str, np.ndarray], prefix: str):
    """Rebuild the reference's own ``ChunkTables`` from saved arrays (its
    paths re-resolved through the reference's memoized discover_path)."""
    from repro.core.carbon.path import discover_path
    from repro.core.scheduler.grid_jax import ChunkTables

    def g(name):
        return arrs[f"{prefix}/{name}"]
    return ChunkTables(
        zcols=tuple(g("zcols")), znoise=g("znoise"),
        cal_a=np.float32(g("cal_a")), cal_b=np.float32(g("cal_b")),
        h_of_day0=float(g("h_of_day0")), day_frac_s=float(g("day_frac_s")),
        dow0=int(g("dow0")), zone_idx=g("zone_idx"), band=g("band"),
        hnoise=g("hnoise"), rel0a=g("rel0a"), anchor_idx=g("anchor_idx"),
        path_idx=g("path_idx"), pair_idx=g("pair_idx"), w_dev=g("w_dev"),
        n_steps=g("n_steps"), rem=g("rem"),
        n_grid_pad=int(g("n_grid_pad")), n_slots_pad=int(g("n_slots_pad")),
        n_hops=int(g("n_hops")), n_pairs=int(g("n_pairs")),
        pair_paths=[discover_path(str(s), str(d))
                    for s, d in g("pair_paths")],
        pair_anchors=list(g("pair_anchors")))


TABLE_ARRAYS = ("znoise", "zone_idx", "band", "hnoise", "rel0a",
                "anchor_idx", "path_idx", "pair_idx", "w_dev", "n_steps",
                "rem")
TABLE_SCALARS = ("cal_a", "cal_b", "h_of_day0", "day_frac_s", "dow0",
                 "n_grid_pad", "n_slots_pad", "n_hops", "n_pairs")


def table_arrays(t) -> Dict[str, np.ndarray]:
    """A ``ChunkTables`` (either package's) as named arrays."""
    d = {k: np.asarray(getattr(t, k)) for k in TABLE_ARRAYS + TABLE_SCALARS}
    d["zcols"] = np.stack(t.zcols)
    d["pair_anchors"] = np.asarray(t.pair_anchors, dtype=np.float64)
    d["pair_paths"] = np.array([(p.src, p.dst) for p in t.pair_paths],
                               dtype=str).reshape(-1, 2)
    return d


def plan_arrays(plans) -> Dict[str, np.ndarray]:
    return {"start_t": np.array([p.start_t for p in plans]),
            "source": np.array([p.source for p in plans], dtype=str),
            "ftn": np.array([p.ftn for p in plans], dtype=str),
            "feasible": np.array([p.feasible for p in plans], dtype=bool),
            "emis": np.array([p.predicted_emissions_g for p in plans]),
            "cost": np.array([p.cost for p in plans]),
            "alternatives": np.array([p.alternatives for p in plans])}


# --- the child process -------------------------------------------------------

def _revive():
    import jax
    import jax.experimental
    # the reference imports this name; jax >= 0.9 keeps it at the top level
    jax.experimental.enable_x64 = jax.enable_x64
    from repro.core.scheduler import grid_jax, grid_pallas
    if not (grid_jax.HAVE_JAX and grid_pallas.PALLAS_AVAILABLE):
        raise RuntimeError("the reference's jax/Pallas paths did not load")
    return grid_jax, grid_pallas


def _child_grid(out: Dict[str, np.ndarray]) -> None:
    grid_jax, _ = _revive()
    from repro.core.scheduler import overlay, planner
    pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                               batch_backend="jax")
    seen = {}
    real = grid_jax.batch_cell_emissions

    def record(field, cells, **kw):
        seen["cells"] = cells
        seen["emis"] = real(field, cells, **kw)
        return seen["emis"]

    grid_jax.batch_cell_emissions = record
    pl.plan_batch_jax(make_jobs(planner, SCALE_CASES["grid"]))
    cells = seen["cells"]
    for j, e in enumerate(seen["emis"]):
        out[f"grid/emis/{j}"] = np.asarray(e)
    out["grid/n_cells"] = np.asarray(len(cells))
    for budget in ("default", "small"):
        max_elems = grid_jax._MAX_ELEMS if budget == "default" else 100_000
        chunks = list(grid_jax._iter_chunks(cells, STRIDE, max_elems))
        out[f"grid/{budget}/n_chunks"] = np.asarray(len(chunks))
        for i, ch in enumerate(chunks):
            out[f"grid/{budget}/{i}/chunk"] = np.asarray(ch)
            t = grid_jax._chunk_tables(pl.field, [cells[j] for j in ch],
                                       dt_s=DT_S, slot_stride=STRIDE,
                                       cell_bucket=grid_jax._B_CELLS)
            for k, v in table_arrays(t).items():
                out[f"grid/{budget}/{i}/tab/{k}"] = v


class _PallasCapture:
    """Stands in for ``grid_pallas.pl``: each ``pallas_call`` runs as is
    and what it returns is kept."""

    def __init__(self, pl):
        self._pl = pl
        self.outputs: list = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *a, **k):
        call = self._pl.pallas_call(*a, **k)

        def run(*args):
            res = call(*args)
            self.outputs.append(res)
            return res
        return run


def _child_fused(out: Dict[str, np.ndarray]) -> None:
    _, grid_pallas = _revive()
    from repro.core.scheduler import overlay, planner
    capture = _PallasCapture(grid_pallas.pl)
    grid_pallas.pl = capture
    tables, inputs = [], []
    real_tables = grid_pallas._chunk_tables

    def record_tables(*a, **k):
        tables.append(real_tables(*a, **k))
        return tables[-1]

    def eager_fused(*args, **kw):       # unjitted, so the capture is concrete
        inputs.append(args)
        return grid_pallas._fused(*args, **kw)

    grid_pallas._chunk_tables = record_tables
    grid_pallas._fused_call = lambda: eager_fused
    cases = dict(EDGE_CASES, drift=SCALE_CASES["drift"])
    for name, specs in cases.items():
        ftns = SCALE_FTNS if name == "drift" else EDGE_FTNS
        pl = planner.CarbonPlanner(make_ftns(overlay, ftns),
                                   batch_backend="pallas")
        if name == "drift":
            pl.emission_scale_fn = drift
        del tables[:], inputs[:], capture.outputs[:]
        plans = pl.plan_batch_jax(make_jobs(planner, specs))
        if pl.batch_backend != "pallas":
            raise RuntimeError(f"{name}: the reference left its Pallas path")
        for k, v in plan_arrays(plans).items():
            out[f"{name}/plans/{k}"] = v
        out[f"{name}/n_chunks"] = np.asarray(len(tables))
        for i, (t, args) in enumerate(zip(tables, inputs)):
            for k, v in table_arrays(t).items():
                out[f"{name}/{i}/tab/{k}"] = v
            for k, v in zip(("pp", "zn", "hn", "rel0", "tc", "pidx", "wd",
                             "sla", "scl"), args):
                out[f"{name}/{i}/in/{k}"] = np.asarray(v)
            r, e = capture.outputs[2 * i]
            out[f"{name}/{i}/out/r"] = np.asarray(r)
            out[f"{name}/{i}/out/e"] = np.asarray(e)
            out[f"{name}/{i}/out/best"] = np.asarray(capture.outputs[2 * i + 1])


def _child_planner(out: Dict[str, np.ndarray]) -> None:
    _revive()
    from repro.core.scheduler import overlay, planner
    for scaled in (False, True):
        pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                                   batch_backend="pallas")
        if scaled:
            pl.emission_scale_fn = drift
        plans = pl.plan_batch(make_jobs(planner, SCALE_CASES["planner"]))
        if pl.batch_backend != "pallas":
            raise RuntimeError("the reference left its Pallas path")
        for k, v in plan_arrays(plans).items():
            out[f"pallas/{'drift' if scaled else 'plain'}/{k}"] = v


def _child_legs(out: Dict[str, np.ndarray]) -> None:
    grid_jax, _ = _revive()
    from repro.core.carbon import path as path_mod
    from repro.core.carbon.energy import HOST_PROFILES
    from repro.core.scheduler import overlay, planner
    scorer = grid_jax.JaxGridScorer()
    for name, routes, size, gbps, starts in LEG_CASES:
        p = leg_path(path_mod, routes)
        out[f"legs/{name}"] = scorer.leg_emissions_g(
            p, HOST_PROFILES["storage_frontend"],
            HOST_PROFILES[LEG_RECEIVER], size, leg_starts(starts), gbps,
            parallelism=LEG_PAR, concurrency=LEG_CON)
        pw = scorer._windows.get((p.src, p.dst, p.hops))
        out[f"legs/{name}/window"] = np.array(
            [pw.t0, pw.hours] if pw is not None else [-1.0, -1.0])
    for scaled in (False, True):
        pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                                   backend="jax", batch_backend="numpy")
        if scaled:
            pl.emission_scale_fn = drift
        tag = "drift" if scaled else "plain"
        job = make_jobs(planner, [LEG_PLAN_JOB])[0]
        for k, v in plan_arrays([pl.plan(job)]).items():
            out[f"legplan/{tag}/plan/{k}"] = v
        jobs = make_jobs(planner, LEG_PLAN_BATCH)
        plans = pl.plan_batch(jobs)
        for k, v in plan_arrays(plans).items():
            out[f"legplan/{tag}/batch/{k}"] = v
        pl.emission_scale_fn = drift if not scaled else None
        re = [pl.rescore(j, p) for j, p in zip(jobs, plans) if p.feasible]
        for k, v in plan_arrays(re).items():
            out[f"legplan/{tag}/rescore/{k}"] = v


def _child_split(out: Dict[str, np.ndarray]) -> None:
    """The reference's ``plan_batch_jax(shard=True)`` over the forced
    devices (its ``shard_map`` of the cell axis), and the tables it
    scored."""
    grid_jax, _ = _revive()
    import jax
    if jax.device_count() != SPLIT_DEVICES:
        raise RuntimeError(f"{jax.device_count()} devices, not "
                           f"{SPLIT_DEVICES}")
    from repro.core.scheduler import overlay, planner
    pl = planner.CarbonPlanner(make_ftns(overlay, SCALE_FTNS),
                               batch_backend="jax")
    real, seen = grid_jax.batch_cell_emissions, {}

    def record(field, cells, **kw):
        seen["shard"], seen["emis"] = kw["shard"], real(field, cells, **kw)
        return seen["emis"]

    grid_jax.batch_cell_emissions = record
    plans = pl.plan_batch_jax(make_jobs(planner, SCALE_CASES["planner"]),
                              shard=True)
    if seen.get("shard") is not True:
        raise RuntimeError("the reference did not score on its batch path")
    for k, v in plan_arrays(plans).items():
        out[f"split/plans/{k}"] = v
    for j, e in enumerate(seen["emis"]):
        out[f"split/emis/{j}"] = np.asarray(e)


def _child_moe_ep(out: Dict[str, np.ndarray]) -> None:
    """Each MOE_EP_CASES case through the reference's ``moe_ffn`` under a
    ``(data, model)`` mesh and the ``"2d"`` rules (its ``shard_map``
    expert-parallel branch): y, aux, and by ``jax.grad`` the gradient of
    sum(y * cot) + MOE_EP_AUX_W * aux for every weight and for x."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_ffn
    from repro.runtime import pspec
    devs = np.array(jax.devices())
    if devs.size != MOE_EP_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {MOE_EP_DEVICES}")
    for case in MOE_EP_CASES:
        name, shape, _, _, gated, n_shared, dense, cf = case
        cfg = MoEConfig(n_experts=MOE_EP_EXPERTS, top_k=MOE_EP_TOP_K,
                        d_ff_expert=MOE_EP_F, n_shared_experts=n_shared,
                        dense_residual=dense, capacity_factor=cf)
        arrs = {k: jnp.asarray(v) for k, v in moe_ep_inputs(case).items()}
        cot = arrs.pop("cot")
        x = arrs.pop("x")

        def loss(p, x):
            y, aux = moe_ffn(p, x, cfg, gated=gated)
            return jnp.sum(y * cot) + MOE_EP_AUX_W * aux, (y, aux)

        # jax.make_mesh gives Explicit axes on jax 0.9, and the reference's
        # branch then fails on a reshape at 4 x 1 (ROADMAP caveats)
        mesh = jax.sharding.Mesh(devs[:shape[0] * shape[1]].reshape(shape),
                                 ("data", "model"))
        with pspec.sharding_scope(mesh, "2d"):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(arrs, x)
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)
        out[f"{name}/grad/x"] = np.asarray(gx)
        for k, g in gp.items():
            out[f"{name}/grad/{k}"] = np.asarray(g)


# --- sequence-parallel attention and the sharded layout -------------------
# (tests/test_torch_seq_attn.py, tests/test_torch_layout.py)
SEQ_DEVICES = 4
SEQ_B, SEQ_S, SEQ_NQ, SEQ_NKV, SEQ_H = 2, 32, 4, 2, 8
SEQ_BLOCK_KV = 8                       # < every band: the blockwise path


def seq_attn_cases() -> List[tuple]:
    """(name, (data, model) mesh, rules, window, impl, block_kv) for every
    mesh x rule set x {global, windowed with the band, windowed without
    it} x {naive, blockwise}. A rank holds Sl = S / model queries; the
    band needs Sl + window < S, so its window is S - Sl - 8 and the
    bandless one S - Sl."""
    out = []
    for shape in ((1, 4), (2, 2)):
        sl = SEQ_S // shape[1]
        for rules in ("seq_2d", "fsdp"):
            for kind, window in (("global", None), ("band", SEQ_S - sl - 8),
                                 ("noband", SEQ_S - sl)):
                for impl, bk in (("naive", 1024),
                                 ("blockwise", SEQ_BLOCK_KV)):
                    out.append((f"{shape[0]}x{shape[1]}_{rules}_{kind}_"
                                f"{impl}", shape, rules, window, impl, bk))
    return out


def seq_attn_inputs(seed: int = 17) -> Dict[str, np.ndarray]:
    """f32 q [B, S, nq, h], k and v [B, S, nkv, h] and a cotangent for the
    output, drawn from a seed."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"q": w(SEQ_B, SEQ_S, SEQ_NQ, SEQ_H),
            "k": w(SEQ_B, SEQ_S, SEQ_NKV, SEQ_H),
            "v": w(SEQ_B, SEQ_S, SEQ_NKV, SEQ_H),
            "cot": w(SEQ_B, SEQ_S, SEQ_NQ, SEQ_H)}


# (label, arch, layers, reference impl, block_kv): gemma3 with one local
# (window 16: a band at Sl = 8) and one global layer on the blockwise path;
# kimi-k2 with one MoE layer (4 experts, one a rank) on the naive one
SEQ_MODELS = (("gemma", "gemma3-12b", 2, "blockwise", SEQ_BLOCK_KV),
              ("kimi", "kimi-k2-1t-a32b", 1, "naive", 1024))
SEQ_MODEL_TOKENS = (2, SEQ_S + 1)


def seq_model_tokens(arch: str) -> np.ndarray:
    return np.random.default_rng(sum(map(ord, arch))).integers(
        0, 256, SEQ_MODEL_TOKENS).astype(np.int32)


def nest(flat: Dict[str, object], prefix: str = "") -> dict:
    """The entries of ``flat`` under ``prefix``, their keys' rest split at
    "/", as a nested tree of dicts (a child's saved leaves back in the
    reference's tree)."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *head, last = key[len(prefix):].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _seq_mesh(shape):
    import jax
    devs = np.array(jax.devices())
    if devs.size != SEQ_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {SEQ_DEVICES}")
    return jax.sharding.Mesh(devs[:shape[0] * shape[1]].reshape(shape),
                             ("data", "model"))


def _seq_rules(pspec, name):
    return pspec.seq_attn_rules("2d") if name == "seq_2d" else name


def _child_seq_attn(out: Dict[str, np.ndarray]) -> None:
    """Each seq_attn_cases case through the reference's
    ``seq_parallel_attention`` (its ``shard_map`` over a ``(data,
    model)`` mesh), jitted: the output and, by ``jax.grad``, the gradient
    of sum(out * cot) for q, k and v."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import seq_parallel_attention
    from repro.runtime import pspec
    arrs = {k: jnp.asarray(v) for k, v in seq_attn_inputs().items()}
    cot = arrs.pop("cot")
    for name, shape, rules, window, impl, bk in seq_attn_cases():
        def loss(q, k, v):
            o = seq_parallel_attention(q, k, v, causal=True, window=window,
                                       impl=impl, block_kv=bk)
            return jnp.sum(o * cot), o

        with pspec.sharding_scope(_seq_mesh(shape), _seq_rules(pspec,
                                                               rules)):
            (_, o), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                arrs["q"], arrs["k"], arrs["v"])
        out[f"{name}/out"] = np.asarray(o)
        for key, gi in zip("qkv", g):
            out[f"{name}/grad/{key}"] = np.asarray(gi)


def _child_seq_models(out: Dict[str, np.ndarray]) -> None:
    """Each SEQ_MODELS model (reduced, f32, weights from PRNGKey(0)) under
    a 1 x 4 mesh and ``seq_attn_rules("2d")``: prefill's last logits, and
    ``loss_fn`` with the gradient of every weight (remat per block), the
    weights themselves beside them."""
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.configs.base import RunConfig
    from repro.models import init_params, loss_fn, prefill
    from repro.runtime import pspec
    for label, arch, layers, impl, bk in SEQ_MODELS:
        cfg = dc.replace(get_reduced(arch, layers=layers), dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        tok = jnp.asarray(seq_model_tokens(arch))
        batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
        run_p = RunConfig(arch=arch, attn_impl=impl, attn_block_kv=bk,
                          remat="none")
        run_t = dc.replace(run_p, remat="block")
        with pspec.sharding_scope(_seq_mesh((1, 4)),
                                  pspec.seq_attn_rules("2d")):
            logits, _ = jax.jit(lambda p, b: prefill(
                p, cfg, run_p, b, s_max=SEQ_S + 4))(params, batch)
            (loss, mets), grads = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(p, cfg, run_t, batch, xent_chunk=0),
                has_aux=True))(params)
        out[f"{label}/logits"] = np.asarray(logits)
        out[f"{label}/loss"] = np.asarray(loss)
        out[f"{label}/aux"] = np.asarray(mets["aux"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(p.key for p in path)
            out[f"{label}/param/{key}"] = np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            key = "/".join(p.key for p in path)
            out[f"{label}/grad/{key}"] = np.asarray(leaf)


LAYOUT_DEVICES = 512                   # launch/dryrun.py's forced count
LAYOUT_MESHES = {"pod1": ((16, 16), ("data", "model")),
                 "pod2": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUT_RULES = ("2d", "fsdp", "dp", "seq_2d")


COST_DEVICES = 8
COST_ARCHS = ("smollm-135m", "kimi-k2-1t-a32b", "mamba2-370m")
COST_CASES = tuple((kind, mesh) for kind, meshes in (
    ("train", ((1, 1, 1), (2, 2, 2), (1, 1, 4), (1, 4, 1))),
    ("prefill", ((1, 1, 1), (2, 2, 2))),
    ("decode", ((1, 1, 1), (2, 2, 2)))) for mesh in meshes)
COST_SEQ, COST_BATCH = 64, 8


def cost_key(arch: str, kind: str, mesh) -> str:
    return f"{arch}|{kind}|{'x'.join(map(str, mesh))}"


def _child_cost(out: Dict[str, np.ndarray]) -> None:
    """``lower_cell`` + ``analyze_lowered`` of the reference on the reduced
    cells of ``tests/test_dryrun_integration.py`` (layers 2, d_model 64,
    vocab 256, seq 64 x batch 8, ``RunConfig(arch, multi_pod=True)``) for
    every COST_CASES kind and ``(pod, data, model)`` mesh, built with
    ``jax.sharding.Mesh`` over the forced host devices, as JSON."""
    import json
    import jax
    from repro.configs import ShapeConfig, get_reduced
    from repro.configs.base import RunConfig
    from repro.runtime import pspec, steps
    from repro.runtime.hlo_analysis import analyze_lowered
    devs = np.array(jax.devices())
    if devs.size != COST_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {COST_DEVICES}")
    res = {}
    for arch in COST_ARCHS:
        cfg = get_reduced(arch, layers=2, d_model=64, vocab=256)
        run = RunConfig(arch=arch, multi_pod=True)
        for kind, sizes in COST_CASES:
            mesh = jax.sharding.Mesh(
                devs[:int(np.prod(sizes))].reshape(sizes),
                ("pod", "data", "model"))
            shape = ShapeConfig("t", seq_len=COST_SEQ,
                                global_batch=COST_BATCH, kind=kind)
            with pspec.sharding_scope(mesh, run.sharding):
                lowered, got = steps.lower_cell(cfg, run, shape)
                hlo = analyze_lowered(lowered, lowered.compile())
            hlo.pop("entry")
            hlo["kind"] = got
            res[cost_key(arch, kind, sizes)] = hlo
    out["cost"] = np.array(json.dumps(res))


# the kernel path (the reference's ``pallas``, the port's ``flash``): the
# cost archs with seamless's non-causal encoder and jamba's hybrid stack
# (at DRYRUN_MOE_EXPERTS), at a seq that is no multiple of the flash
# kernel's 128-row blocks (the padded grid) and is whole scan chunks (32
# in the reduced Mamba-2 layers); two groups, two child processes
KERNEL_COST_GROUPS = {
    "attention": ("smollm-135m", "kimi-k2-1t-a32b", "seamless-m4t-medium"),
    "ssm": ("mamba2-370m", "jamba-v0.1-52b")}
KERNEL_COST_ARCHS = tuple(a for g in KERNEL_COST_GROUPS.values() for a in g)
KERNEL_COST_SEQ = 192
# decode attends one token and steps the SSM state: it reaches no kernel
KERNEL_COST_CASES = tuple(c for c in COST_CASES if c[0] != "decode")
# one kernel call alone, jitted on one device: flash (B, T, S, Hq, Hkv, d,
# causal, window) with T and S no multiples of 128 (the attention group),
# and the SSD scan (B, S, nh, hd, N, chunk) (the ssm group)
KERNEL_FLASH_CALLS = ((2, 192, 192, 4, 2, 16, True, None),
                      (1, 100, 300, 2, 2, 32, False, None),
                      (1, 200, 200, 4, 4, 16, True, 64))
KERNEL_SSD_CALLS = ((2, 192, 8, 16, 16, 32), (1, 256, 4, 32, 64, 64))


def kernel_call_key(kind: str, case) -> str:
    return f"{kind}|{'|'.join(map(str, case))}"


def _child_cost_kernel(out: Dict[str, np.ndarray], group: str) -> None:
    """:func:`_child_cost` under ``attn_impl="pallas"`` (the Pallas
    kernels lowered in interpret mode) for the archs of
    ``KERNEL_COST_GROUPS[group]`` at seq KERNEL_COST_SEQ, every
    KERNEL_COST_CASES case, with each case's compiled argument bytes; and
    the dot FLOPs of the group's kernel called alone (KERNEL_FLASH_CALLS,
    the first also with 4 x its batch split over 4 devices, or
    KERNEL_SSD_CALLS), as JSON."""
    import json
    import jax
    from repro.configs import ShapeConfig, get_reduced
    from repro.configs.base import RunConfig
    from repro.kernels import ops
    from repro.runtime import pspec, steps
    from repro.runtime.hlo_analysis import analyze_lowered
    devs = np.array(jax.devices())
    if devs.size != COST_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {COST_DEVICES}")
    bf16, f32 = jax.numpy.bfloat16, jax.numpy.float32
    res = {}

    def alone(fn, *shapes, n=1):
        mesh = jax.sharding.Mesh(devs[:n].reshape(n), ("data",))
        split = jax.sharding.NamedSharding(mesh,
                                           jax.sharding.PartitionSpec("data"))
        args = [jax.ShapeDtypeStruct(sh, dt, sharding=split)
                for sh, dt in shapes]
        lowered = jax.jit(fn, out_shardings=split).lower(*args)
        return analyze_lowered(lowered, lowered.compile())[
            "dot_flops_per_chip"]

    if group == "attention":
        for case in KERNEL_FLASH_CALLS:
            b, t, s, hq, hkv, d, causal, window = case
            for n, key in ((1, kernel_call_key("flash", case)),
                           (4, "flash_batch_over_4")):
                if n == 4 and case != KERNEL_FLASH_CALLS[0]:
                    continue
                res[key] = alone(
                    lambda q, k, v: ops.flash_attention(q, k, v, causal,
                                                        window),
                    ((n * b, t, hq, d), bf16), ((n * b, s, hkv, d), bf16),
                    ((n * b, s, hkv, d), bf16), n=n)
    else:
        for case in KERNEL_SSD_CALLS:
            b, s, nh, hd, n, q = case
            res[kernel_call_key("ssd", case)] = alone(
                lambda *a: ops.ssd_scan(*a, chunk=q), ((b, s, nh, hd), bf16),
                ((b, s, nh), f32), ((nh,), f32), ((b, s, 1, n), bf16),
                ((b, s, 1, n), bf16))
    for arch in KERNEL_COST_GROUPS[group]:
        cfg = dryrun_config(get_reduced, arch)
        run = RunConfig(arch=arch, multi_pod=True, attn_impl="pallas")
        for kind, sizes in KERNEL_COST_CASES:
            mesh = jax.sharding.Mesh(
                devs[:int(np.prod(sizes))].reshape(sizes),
                ("pod", "data", "model"))
            shape = ShapeConfig("t", seq_len=KERNEL_COST_SEQ,
                                global_batch=COST_BATCH, kind=kind)
            with pspec.sharding_scope(mesh, run.sharding):
                lowered, got = steps.lower_cell(cfg, run, shape)
                compiled = lowered.compile()
                hlo = analyze_lowered(lowered, compiled)
                mem = compiled.memory_analysis()
            hlo.pop("entry")
            hlo["kind"] = got
            hlo["argument_bytes"] = int(mem.argument_size_in_bytes)
            res[cost_key(arch, kind, sizes)] = hlo
    out["cost_kernel"] = np.array(json.dumps(res))


DRYRUN_DEVICES = 512                   # launch/dryrun.py's forced count
DRYRUN_REDUCED = dict(layers=2, d_model=64, vocab=256)
# the MoE archs at 16 experts: the reference's moe.py:125 asks n_experts
# to divide the 16-wide 'model' axis
DRYRUN_MOE_ARCHS = ("jamba-v0.1-52b", "arctic-480b", "kimi-k2-1t-a32b")
DRYRUN_MOE_EXPERTS = 16


def dryrun_cells(cells_fn) -> List[tuple]:
    """(arch, shape name, multi_pod): every cell of ``cells_fn(
    include_skips=True)`` on 16 x 16, then ``train_4k`` and ``decode_32k``
    of COST_ARCHS on 2 x 16 x 16."""
    out = [(a, s.name, False) for a, s, _ in cells_fn(include_skips=True)]
    out += [(a, s, True) for a in COST_ARCHS
            for s in ("train_4k", "decode_32k")]
    return out


def dryrun_config(get_reduced, arch: str):
    """The reduced config the dry-run tests give both packages' dry runs."""
    kw = dict(DRYRUN_REDUCED)
    if arch in DRYRUN_MOE_ARCHS:
        kw["n_experts"] = DRYRUN_MOE_EXPERTS
    return get_reduced(arch, **kw)


def dryrun_key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}|{shape}|{'2x16x16' if multi_pod else '16x16'}"


# the dry-run cells whose ``flash`` path reaches a kernel in the port: the
# SSD scan (mamba2, jamba's SSM layers) and seamless's non-causal encoder
KERNEL_DRYRUN_CELLS = tuple((a, s, False) for a in (
    "mamba2-370m", "jamba-v0.1-52b", "seamless-m4t-medium")
    for s in ("train_4k", "prefill_32k")) + (("mamba2-370m", "train_4k",
                                              True),)


def _dryrun_records(cells_todo, extra: List[str]) -> Dict:
    """The reference's own ``launch/dryrun.py`` ``main(["--arch", a,
    "--shape", s, ("--multi-pod",) "--json", p] + extra)`` on each of
    ``cells_todo``, its production meshes built with ``jax.sharding.Mesh``
    over the 512 forced devices and its configs reduced
    (:func:`dryrun_config`): one record a cell, by :func:`dryrun_key`."""
    import json
    import tempfile
    import jax
    from repro.configs import get_reduced
    from repro.launch import dryrun as D
    devs = np.array(jax.devices())
    if devs.size != DRYRUN_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {DRYRUN_DEVICES}")

    def mesh(*, multi_pod=False):
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.sharding.Mesh(devs[:int(np.prod(sizes))].reshape(sizes),
                                 names)

    D.make_production_mesh = mesh
    D.get_config = lambda arch: dryrun_config(get_reduced, arch)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, mp in cells_todo:
            path = os.path.join(d, "cell.json")
            argv = ["--arch", arch, "--shape", shape, "--json", path] + extra
            if D.main(argv + (["--multi-pod"] if mp else [])) != 0:
                raise RuntimeError(f"reference dry run failed: {argv}")
            with open(path) as f:
                (rec,) = json.load(f)
            res[dryrun_key(arch, shape, mp)] = rec
    return res


def _child_dryrun(out: Dict[str, np.ndarray]) -> None:
    """:func:`_dryrun_records` of every cell of :func:`dryrun_cells`, as
    JSON."""
    import json
    from repro.configs import cells
    out["dryrun"] = np.array(json.dumps(_dryrun_records(
        dryrun_cells(cells), [])))


def _child_dryrun_kernel(out: Dict[str, np.ndarray]) -> None:
    """:func:`_dryrun_records` of KERNEL_DRYRUN_CELLS under ``--attn-impl
    pallas``, as JSON."""
    import json
    out["dryrun_kernel"] = np.array(json.dumps(_dryrun_records(
        KERNEL_DRYRUN_CELLS, ["--attn-impl", "pallas"])))


REMAT_SEQS = (1024, 1536, 4096)
REMAT_MODES = ("none", "block")
REMAT_BATCH = 16


def remat_key(seq: int, remat: str) -> str:
    return f"{seq}|{remat}"


def _child_remat(out: Dict[str, np.ndarray]) -> None:
    """The reference's blockwise train-step dot FLOPs (``lower_cell`` +
    ``analyze_lowered``) of reduced smollm at batch REMAT_BATCH on one
    device, for every REMAT_SEQS length and REMAT_MODES remat, as JSON."""
    import json
    import jax
    from repro.configs import ShapeConfig, get_reduced
    from repro.configs.base import RunConfig
    from repro.runtime import pspec, steps
    from repro.runtime.hlo_analysis import analyze_lowered
    cfg = get_reduced("smollm-135m", **DRYRUN_REDUCED)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                             ("pod", "data", "model"))
    res = {}
    for seq in REMAT_SEQS:
        for remat in REMAT_MODES:
            run = RunConfig(arch="smollm-135m", remat=remat,
                            attn_impl="blockwise")
            shape = ShapeConfig("t", seq_len=seq, global_batch=REMAT_BATCH,
                                kind="train")
            with pspec.sharding_scope(mesh, run.sharding):
                lowered, _ = steps.lower_cell(cfg, run, shape)
                hlo = analyze_lowered(lowered, lowered.compile())
            res[remat_key(seq, remat)] = hlo["dot_flops_per_chip"]
    out["remat"] = np.array(json.dumps(res))


def rehearse_phase_20(chip_smoke, monkeypatch) -> None:
    """``chip_smoke.py``'s phase 20 on the CPU at reduced size: configs
    reduced, ``DEVICE = "cpu"``, CUDA synchronisation and events stubbed,
    and ``card_memory`` measured on the CPU run itself: the bytes of the
    step's arguments (the model's parameters, the optimizer state, the
    batch) and the most the call allocates over them, as the cost trace's
    storage tracking sees real CPU tensors; the kernels' wrappers count
    their CPU calls as launches (:func:`launch_counters`)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import cost_analysis as CA
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda a: configs.reduced(
        real(a), layers=2, d_model=64, vocab=256))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def elapsed_time(self, _):
            return 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    args: List = []
    build, init, batch = M.build_model, adamw.adamw_init, M.make_batch

    def build_model(*a, **k):
        args.clear()
        model = build(*a, **k)
        args.extend(model.parameters())
        return model

    def adamw_init(params):
        opt = init(params)
        args.extend(t for f in ("master", "m", "v")
                    for t in getattr(opt, f).values())
        return opt

    def make_batch(*a, **k):
        out = batch(*a, **k)
        args.extend(out.values())
        return out

    def card_memory(call):
        got = {}

        def run():
            call()
            got["peak"] = CA.active().peak

        CA._run(run, None, None, (), (), False, list(args))
        before = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                      for t in args}.values())
        return before, before + got["peak"]

    monkeypatch.setattr(M, "build_model", build_model)
    monkeypatch.setattr(adamw, "adamw_init", adamw_init)
    monkeypatch.setattr(M, "make_batch", make_batch)
    monkeypatch.setattr(chip_smoke, "card_memory", card_memory)
    launch_counters(monkeypatch)


def _counting(real):
    def counted(*args, **kwargs):
        if args[0].device.type == "cpu":
            counted.launches += 1
        return real(*args, **kwargs)

    counted.launches = 0
    return counted


def launch_counters(monkeypatch) -> None:
    """Wrap ``flash_attention.flash_attention`` and ``ssd_scan.ssd_scan``
    (which ``kernels/ops.py`` looks up at call time) in counters of their
    calls on CPU tensors, in each wrapper's ``launches``: a CPU rehearsal's
    stand-in for the card's launches (a meta call launches nothing)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    for mod, name in ((fa, "flash_attention"), (ssd, "ssd_scan")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))


def _entry_json(e):
    return list(e) if isinstance(e, tuple) else e


def _child_layout(out: Dict[str, np.ndarray]) -> None:
    """The reference's sharded layout on both production meshes (built with
    ``jax.sharding.Mesh`` over the 512 forced devices) under each of
    LAYOUT_RULES, for every arch at full size, as JSON: per leaf of the
    params, the optimizer state (``zero_pod``), every shape's batch and
    the decode cache (``seq_shard`` both ways, decode_32k's) the spec,
    ``NamedSharding.shard_shape``, shape and dtype; ``choose_seq_attn``
    for every cell of ``cells()``; and the shape kind and
    ``choose_seq_attn`` of every cell of ``cells(include_skips=True)``,
    which ``lower_cell`` branches on."""
    import json
    import jax
    from repro.configs import ARCHS, SHAPES, cells, get_config
    from repro.models import kvcache as KC
    from repro.models import model as RM
    from repro.models import params as RP
    from repro.optim.adamw import abstract_opt_state
    from repro.runtime import pspec, steps
    devs = np.array(jax.devices())
    if devs.size != LAYOUT_DEVICES:
        raise RuntimeError(f"{devs.size} devices, not {LAYOUT_DEVICES}")

    def leaves(shardings, abstract):
        got = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
        shard = dict(jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda t: t is None)[0])
        for path, a in flat:
            sh = shard[path]
            key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                           for p in path)
            got[key] = [[_entry_json(e) for e in sh.spec],
                        list(sh.shard_shape(a.shape)), list(a.shape),
                        str(a.dtype)]
        return got

    res = {}
    for mname, (sizes, names) in LAYOUT_MESHES.items():
        mesh = jax.sharding.Mesh(devs[:int(np.prod(sizes))].reshape(sizes),
                                 names)
        for rules in LAYOUT_RULES:
            with pspec.sharding_scope(mesh, _seq_rules(pspec, rules)):
                res[f"{mname}|{rules}|choose"] = {
                    f"{a}|{sh.name}": bool(steps.choose_seq_attn(
                        get_config(a), sh)) for a, sh, _ in cells()}
                res[f"{mname}|{rules}|cells"] = {
                    f"{a}|{sh.name}": [sh.kind, bool(steps.choose_seq_attn(
                        get_config(a), sh))]
                    for a, sh, _ in cells(include_skips=True)}
                for arch in ARCHS:
                    cfg = get_config(arch)
                    p_abs = RP.abstract_params(cfg)
                    row = {"params": leaves(RP.param_shardings(cfg), p_abs),
                           "opt": leaves(steps.opt_shardings(cfg),
                                         abstract_opt_state(p_abs))}
                    for sh in SHAPES:
                        row[f"batch|{sh.name}"] = leaves(
                            steps.batch_shardings(cfg, sh),
                            RM.input_specs(cfg, sh))
                    dec = SHAPES[2]
                    enc = dec.seq_len // 4 if cfg.family == "encdec" else 0
                    c_abs = KC.abstract_cache(cfg, dec.global_batch,
                                              dec.seq_len, enc)
                    for seq in (False, True):
                        axes = KC.cache_logical_axes(cfg, seq_shard=seq)
                        row[f"cache|{seq}"] = leaves(jax.tree.map(
                            lambda ax, s: pspec.named_sharding(
                                ax, shape=s.shape), axes, c_abs,
                            is_leaf=lambda t: isinstance(t, tuple)), c_abs)
                    res[f"{mname}|{rules}|{arch}"] = row
    out["layout"] = np.array(json.dumps(res))


if __name__ == "__main__":
    path, what = Path(sys.argv[1]), sys.argv[2]
    arrays: Dict[str, np.ndarray] = {}
    {"grid": _child_grid, "fused": _child_fused,
     "planner": _child_planner, "legs": _child_legs,
     "split": _child_split, "moe_ep": _child_moe_ep,
     "seq_attn": _child_seq_attn, "seq_models": _child_seq_models,
     "layout": _child_layout, "cost": _child_cost,
     "cost_kernel_attention": lambda o: _child_cost_kernel(o, "attention"),
     "cost_kernel_ssm": lambda o: _child_cost_kernel(o, "ssm"),
     "dryrun_kernel": _child_dryrun_kernel,
     "dryrun": _child_dryrun, "remat": _child_remat}[what](arrays)
    np.savez(path, **arrays)
