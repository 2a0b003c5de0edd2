"""The port's mesh layer (``repro_torch/runtime/pspec.py``,
``repro_torch/launch/mesh.py``) against the reference's, on the CPU.

``resolve`` is held to the reference's entry for entry on shape-only
meshes (2 x 2, 2 and 2 x 2 x 2) under the ``2d``, ``fsdp`` and ``dp``
rules and the context-parallel variant, over drawn logical specs and
shapes; the rest is the port's own contract: the host mesh, the scope,
and sequence-parallel attention refused until it is ported.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, hst
from repro.models.layers import use_seq_parallel as ref_use_seq_parallel
from repro.runtime import pspec as rpspec
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.runtime import pspec as PS

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2": ((2,), ("data",)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
NAMES = sorted(PS.DEFAULT_RULES) + ["not_a_rule"]


def _rules(pkg, name):
    return pkg.seq_attn_rules("2d") if name == "seq_2d" else name


_item = hst.one_of(hst.none(), hst.sampled_from(NAMES),
                   hst.tuples(hst.sampled_from(NAMES),
                              hst.sampled_from(NAMES)))


def _both(mesh, rules, fn):
    sizes, names = MESHES[mesh]
    with rpspec.sharding_scope(rpspec.abstract_mesh(sizes, names),
                               _rules(rpspec, rules)):
        want = fn(rpspec)
    with PS.sharding_scope(PS.abstract_mesh(sizes, names),
                           _rules(PS, rules)):
        got = fn(PS)
    return got, want


@given(mesh=hst.sampled_from(sorted(MESHES)),
       rules=hst.sampled_from(["2d", "fsdp", "dp", "seq_2d"]),
       spec=hst.lists(_item, min_size=1, max_size=4),
       dims=hst.lists(hst.integers(1, 12), min_size=4, max_size=4),
       with_shape=hst.booleans())
def test_resolve_matches_reference(mesh, rules, spec, dims, with_shape):
    shape = dims[:len(spec)] if with_shape else None
    got, want = _both(mesh, rules, lambda pkg: pkg.resolve(spec, shape))
    assert got == tuple(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", ["2d", "fsdp", "dp", "seq_2d"])
def test_axis_sizes_and_moe_specs_match_reference(mesh, rules):
    """Every rule's logical axis size, and the specs the expert-parallel
    MoE reads: the token split of 16 and of 15 tokens and the experts'."""
    def specs(pkg):
        return ([pkg.logical_axis_size(n) for n in NAMES],
                [tuple(pkg.resolve(("batch", None), shape=(t, 8)))
                 for t in (16, 15)],
                tuple(pkg.resolve(("expert", "fsdp", None))))
    got, want = _both(mesh, rules, specs)
    assert got == want


def test_rule_tables_are_the_references():
    assert PS.RULE_SETS == rpspec.RULE_SETS
    assert PS.seq_attn_rules("fsdp") == rpspec.seq_attn_rules("fsdp")


def test_scope_restores_nests_and_is_per_thread():
    assert PS.active_mesh() is None
    outer, inner = PS.abstract_mesh((2,), ("data",)), make_host_mesh(
        2, device="cpu")
    seen = []
    with PS.sharding_scope(outer, "dp"):
        with PS.sharding_scope(inner):
            assert PS.active_mesh() is inner
            assert PS.logical_axis_size("heads") == 1   # model axis is 1
            t = threading.Thread(target=lambda: seen.append(
                PS.active_mesh()))
            t.start()
            t.join(10)
            assert PS.current_scope()[0] is inner
        assert PS.active_mesh() is outer
        assert PS.logical_axis_size("batch") == 2
    assert PS.active_mesh() is None and seen == [None]


def test_host_mesh_holds_repeated_devices_by_name():
    mesh = PS.HostMesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="axis names"):
        PS.HostMesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(ValueError, match="repeat"):
        PS.abstract_mesh((2, 2), ("data", "data"))


def test_make_host_mesh(monkeypatch):
    mesh = make_host_mesh(3, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 3, "model": 1}
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_host_mesh()
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert make_host_mesh(1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="3 devices asked for, 2"):
        make_host_mesh(3)


# --- sequence-parallel attention: taken where the predicate holds -----------

def _qk(T, S):
    return torch.zeros(1, T, 2, 4), torch.zeros(1, S, 2, 4)


@pytest.mark.parametrize("rules,model,T,S,want", [
    ("2d", 2, 8, 8, False),            # heads map to 'model'
    ("fsdp", 2, 8, 8, True),           # fsdp replicates heads
    ("seq_2d", 2, 8, 8, True),
    ("seq_2d", 1, 8, 8, False),        # no model axis to split over
    ("seq_2d", 2, 1, 8, False),        # decode
    ("seq_2d", 2, 7, 7, False),        # the axis does not divide S
    ("dp", 2, 8, 8, False),            # seq_model maps to nothing
])
def test_use_seq_parallel_matches_reference(rules, model, T, S, want):
    sizes, names = (2, model), ("data", "model")
    q, k = _qk(T, S)
    with PS.sharding_scope(PS.abstract_mesh(sizes, names),
                           _rules(PS, rules)):
        got = layers.use_seq_parallel(q, k)
    with rpspec.sharding_scope(rpspec.abstract_mesh(sizes, names),
                               _rules(rpspec, rules)):
        ref = ref_use_seq_parallel(jnp.zeros(q.shape), jnp.zeros(k.shape))
    assert got == ref == want
    assert not layers.use_seq_parallel(q, k)      # no mesh


@pytest.fixture(scope="module")
def small_dense():
    cfg = get_reduced("gemma3-12b", layers=2)
    model = M.build_model(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    return model, tokens


@pytest.mark.parametrize("rules", ["seq_2d", "fsdp"])
def test_seq_parallel_attention_raises_naming_item_11(small_dense, rules):
    """Item 11 ported it: where the predicate holds, prefill no longer
    raises but runs sequence-parallel attention, and its logits are the
    unmeshed ones to f32 noise (held against the reference's in
    tests/test_torch_seq_attn.py)."""
    model, tokens = small_dense
    run = RunConfig(arch="g", attn_impl="naive", remat="none")
    want, _ = M.prefill(model, run, tokens, 20)
    calls = []
    real = layers.seq_parallel_attention
    layers.seq_parallel_attention = lambda *a, **k: (
        calls.append(1), real(*a, **k))[1]
    try:
        with PS.sharding_scope(PS.HostMesh([["cpu", "cpu"]],
                                           ("data", "model")),
                               _rules(PS, rules)):
            got, _ = M.prefill(model, run, tokens, 20)
    finally:
        layers.seq_parallel_attention = real
    assert len(calls) == len(model.decoder.layers)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-2


def test_dense_model_under_2d_mesh_is_unchanged(small_dense):
    """Under the 2d rules a model without experts reads no mesh: prefill
    is the unmeshed one bit for bit."""
    model, tokens = small_dense
    run = RunConfig(arch="g", attn_impl="naive", remat="none")
    want, _ = M.prefill(model, run, tokens, 20)
    with PS.sharding_scope(PS.HostMesh([["cpu", "cpu"], ["cpu", "cpu"]],
                                       ("data", "model")), "2d"):
        got, _ = M.prefill(model, run, tokens, 20)
    assert torch.equal(got, want)
