"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py`` on the CPU, function by function:
capacity, routing, the dispatch's ranks and drops, the whole layer with
the shared-expert and dense-residual branches, and its gradients.

Inputs are seeded numpy normals. Tolerances: capacities and dispatch
indices exact; routing probabilities and aux within 1e-6 (f32 softmax of
the same f32 logits); the layer in f32 within 1e-5 of its largest output
and its gradients within 1e-5 of each leaf's largest value (f32 sum
order); in bf16 within 2e-2 (a few bf16 ulps of the largest output: the
expert products round to bf16 at the same places on both sides, and XLA
and torch round their elementwise steps differently).
"""
import math

import numpy as np
import pytest
import torch

import _torch_ref
from repro_torch.configs.base import MoEConfig as TC
from repro_torch.models import moe

D, F_EXP, F_DENSE = 32, 24, 40
F32_REL, BF16_REL, GRAD_REL, ROUTE_ABS = 1e-5, 2e-2, 1e-5, 1e-6

# name -> (n_experts, top_k, shared experts, dense residual, gated)
VARIANTS = {"plain": (8, 2, 0, False, True),
            "shared": (8, 4, 1, False, True),
            "dense": (8, 2, 0, True, True),
            "gelu": (6, 2, 0, False, False)}


@pytest.fixture(scope="module", autouse=True)
def _warm():
    _torch_ref.warm_up_torch()


def _cfgs(E, k, shared=0, dense=False, cf=1.25):
    from repro.configs.base import MoEConfig as RC
    kw = dict(n_experts=E, top_k=k, d_ff_expert=F_EXP,
              n_shared_experts=shared, dense_residual=dense,
              capacity_factor=cf)
    return RC(**kw), TC(**kw)


def _params(E, shared, dense, gated, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    names = ("wg", "wu") if gated else ("wu",)
    p = {"router": w(D, E, scale=1.0 / math.sqrt(D)),
         **{n: w(E, D, F_EXP) for n in names}, "wd": w(E, F_EXP, D)}
    for pre, width, on in (("shared", F_EXP * shared, shared),
                           ("dense", F_DENSE, dense)):
        if on:
            p.update({f"{pre}_{n}": w(D, width) for n in names})
            p[f"{pre}_wd"] = w(width, D)
    return p


def _x(B=2, S=40, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_reference(cf):
    from repro.models import moe as ref
    for T in (1, 4, 7, 64, 1000, 8192, 8320):
        for E in (4, 16, 128, 384):
            for k in (1, 2, 8):
                if k > E:
                    continue
                cfg_r, cfg_t = _cfgs(E, k, cf=cf)
                got, want = moe.capacity(T, cfg_t), ref.capacity(T, cfg_r)
                assert got == want, (T, E, k, cf)
                assert got % 8 == 0 and got >= 8


@pytest.mark.parametrize("overflow", [False, True])
def test_dispatch_indices_bit_equal(overflow):
    """Seeded top-k choices skewed toward the low experts; with
    ``overflow`` the capacity is below the busiest experts' load, so
    assignments are dropped in flat order."""
    import jax.numpy as jnp
    from repro.models import moe as ref
    rng = np.random.default_rng(7)
    T, k, E = 300, 2, 8
    weights = np.linspace(3.0, 1.0, E)
    top_i = np.stack([rng.choice(E, size=k, replace=False,
                                 p=weights / weights.sum())
                      for _ in range(T)]).astype(np.int64)
    cap = 48 if overflow else 160
    want = ref.dispatch_indices(jnp.asarray(top_i, jnp.int32), E, cap)
    got = moe.dispatch_indices(torch.as_tensor(top_i), E, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    assert (not keep.all()) == overflow
    # every expert keeps its first `cap` assignments in flat order
    e_flat = top_i.reshape(-1)
    for e in range(E):
        idx = np.nonzero(e_flat == e)[0]
        assert keep[idx[:cap]].all() and not keep[idx[cap:]].any()


@pytest.mark.parametrize("E,k", [(8, 2), (16, 2), (384, 8)])
def test_route_matches_reference(E, k):
    import jax.numpy as jnp
    from repro.models import moe as ref
    cfg_r, cfg_t = _cfgs(E, k)
    rng = np.random.default_rng(E)
    x = rng.standard_normal((96, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / math.sqrt(D)).astype(np.float32)
    p_r, i_r, a_r = ref.route(jnp.asarray(w), jnp.asarray(x), cfg_r)
    p_t, i_t, a_t = moe.route(torch.as_tensor(w), torch.as_tensor(x), cfg_t)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    assert np.abs(p_t.numpy() - np.asarray(p_r)).max() <= ROUTE_ABS
    assert abs(float(a_t) - float(a_r)) <= ROUTE_ABS
    assert p_t.dtype == torch.float32


def test_route_breaks_ties_toward_the_lower_expert():
    """``lax.top_k`` takes the lower index on a tie; so does the port's
    stable descending sort, on any device."""
    cfg = TC(n_experts=4, top_k=2, d_ff_expert=8)
    x = torch.ones((3, 2))
    w = torch.tensor([[1.0, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 0.0]])
    _, top_i, _ = moe.route(w, x, cfg)
    assert top_i.tolist() == [[1, 2]] * 3


def _both(variant, cf, dtype):
    import jax.numpy as jnp
    from repro.models import moe as ref
    E, k, shared, dense, gated = VARIANTS[variant]
    cfg_r, cfg_t = _cfgs(E, k, shared, dense, cf)
    p = _params(E, shared, dense, gated)
    x = _x()
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    y_r, a_r = ref.moe_ffn({n: jnp.asarray(v, jd) for n, v in p.items()},
                           jnp.asarray(x, jd), cfg_r, gated=gated)
    y_t, a_t = moe.moe_ffn({n: torch.as_tensor(v).to(td)
                            for n, v in p.items()},
                           torch.as_tensor(x).to(td), cfg_t, gated=gated)
    T = x.shape[0] * x.shape[1]
    top_i = moe.route(torch.as_tensor(p["router"]),
                      torch.as_tensor(x).reshape(T, D), cfg_t)[1]
    keep = moe.dispatch_indices(top_i, E, moe.capacity(T, cfg_t))[2]
    return (np.asarray(y_r.astype(jnp.float32)), float(a_r),
            y_t.float().numpy(), float(a_t), y_t.dtype, int((~keep).sum()))


@pytest.mark.parametrize("drops", [False, True],
                         ids=["no_drops", "drops_forced"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_ffn_matches_reference_f32(variant, drops):
    """The routed experts alone, with the shared experts, with the dense
    residual, and alone on an ungated (tanh-GELU) FFN (the reference's
    branches read ``shared_wg``/``dense_wg`` even when ungated, so it has
    no ungated variant with them); capacity factor 0.25 forces drops, 4.0
    leaves none."""
    y_r, a_r, y_t, a_t, dt, n_drop = _both(variant, 0.25 if drops else 4.0,
                                           "float32")
    assert (n_drop > 0) == drops
    assert dt == torch.float32
    assert _rel(y_t, y_r) <= F32_REL
    assert abs(a_t - a_r) <= ROUTE_ABS


@pytest.mark.parametrize("variant", ["plain", "dense"])
def test_moe_ffn_matches_reference_bf16(variant):
    y_r, a_r, y_t, a_t, dt, n_drop = _both(variant, 0.5, "bfloat16")
    assert dt == torch.bfloat16 and n_drop > 0
    assert _rel(y_t, y_r) <= BF16_REL
    assert abs(a_t - a_r) <= ROUTE_ABS


@pytest.mark.parametrize("variant", ["plain", "shared", "dense", "gelu"])
def test_moe_ffn_gradients_match_jax_grad(variant):
    """d(sum(y * g) + 3 aux) with respect to x and every weight, drops
    forced (capacity factor 0.5): the dropped assignments carry no
    gradient on either side."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as ref
    E, k, shared, dense, gated = VARIANTS[variant]
    cfg_r, cfg_t = _cfgs(E, k, shared, dense, 0.5)
    p = _params(E, shared, dense, gated)
    x = _x()
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_obj(p, x):
        y, aux = ref.moe_ffn(p, x, cfg_r, gated=gated)
        return jnp.sum(y * g) + 3.0 * aux

    gp_r, gx_r = jax.grad(ref_obj, argnums=(0, 1))(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    pt = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_ffn(pt, xt, cfg_t, gated=gated)
    (torch.sum(y * torch.as_tensor(g)) + 3.0 * aux).backward()
    assert _rel(xt.grad.numpy(), gx_r) <= GRAD_REL
    for n, t in pt.items():
        assert _rel(t.grad.numpy(), gp_r[n]) <= GRAD_REL, n


def test_router_runs_in_true_f32_whatever_the_switch(monkeypatch):
    """``route`` turns TF32 off for its product and restores the
    process-wide switch after."""
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    moe.route(torch.randn(8, 4), torch.randn(3, 8),
              TC(n_experts=4, top_k=2, d_ff_expert=8))
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True


@pytest.mark.parametrize("before", [True, False])
def test_route_restores_the_switch_when_it_raises(monkeypatch, before):
    """A router product that raises (mismatched widths) leaves the
    process-wide TF32 switch as it found it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
    with pytest.raises(RuntimeError):
        moe.route(torch.randn(5, 4), torch.randn(3, 8),
                  TC(n_experts=4, top_k=2, d_ff_expert=8))
    assert torch.backends.cuda.matmul.allow_tf32 is before


def test_ieee_f32_blocks_of_several_threads_restore_the_switch(monkeypatch):
    """Threads that enter ``ieee_f32`` together each see TF32 off inside
    and leave the switch as it was before any of them."""
    import threading
    import time
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    inside = []
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(50):
            with moe.ieee_f32():
                time.sleep(0)
                inside.append(torch.backends.cuda.matmul.allow_tf32)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(inside) == 400 and not any(inside)
    assert torch.backends.cuda.matmul.allow_tf32 is True
