"""A cell's per-device cost without HLO (``steps.lower_cell`` +
``runtime.cost_analysis.analyze_cell``) against the reference's compiled
counts, on the CPU.

The reference lowers and compiles the reduced cells of
``tests/test_dryrun_integration.py`` (layers 2, d_model 64, vocab 256, seq
64 x batch 8) in a child process on 8 forced host devices, its meshes
built with ``jax.sharding.Mesh`` (``tests/_torch_ref.py::_child_cost``),
and reads them with ``analyze_lowered``. The port traces the same cells on
meta tensors under shape-only meshes of the same axes. Dot FLOPs per chip
agree within 1 % on every case and exactly on the one-device cases but
mamba2's train step, whose gap is pinned to the op. Collectives are
analytic: zero on one device, positive on every other mesh, hand-counted
in small cases. The mapped regions' one-coordinate counts are held to the
``HostMesh`` loops, and three named faults fail.
"""
import inspect
import json
import math
import textwrap
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_ref as ref
from repro_torch.configs import cells, get_config, get_reduced
from repro_torch.configs.base import MoEConfig, RunConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers, moe
from repro_torch.runtime import cost_analysis as CA
from repro_torch.runtime import pspec as PS
from repro_torch.runtime import steps

REL = 0.01
AXES = ("pod", "data", "model")
CASES = [(a, k, m) for a in ref.COST_ARCHS for k, m in ref.COST_CASES]
# mamba2's train step is the one one-device case that is not exact
INEXACT = {("mamba2-370m", "train")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    arrs = ref.run_reference("cost", tmp_path_factory.mktemp("ref")
                             / "cost.npz", timeout=600,
                             host_devices=ref.COST_DEVICES)
    return json.loads(str(arrs["cost"]))


def lower(arch: str, kind: str, mesh) -> steps.LoweredCell:
    cfg = get_reduced(arch, layers=2, d_model=64, vocab=256)
    run = RunConfig(arch=arch, multi_pod=True)
    shape = ShapeConfig("t", seq_len=ref.COST_SEQ,
                        global_batch=ref.COST_BATCH, kind=kind)
    with PS.sharding_scope(PS.abstract_mesh(mesh, AXES), run.sharding):
        low, got = steps.lower_cell(cfg, run, shape)
    assert got == kind == low.kind
    return low


def port_cost(arch: str, kind: str, mesh) -> dict:
    return CA.analyze_cell(lower(arch, kind, mesh))


def _case_id(case) -> str:
    return ref.cost_key(*case)


def _off(reference, case) -> float:
    """The port's dot FLOPs per chip relative to the reference's, - 1."""
    want = reference[ref.cost_key(*case)]["dot_flops_per_chip"]
    return port_cost(*case)["dot_flops_per_chip"] / want - 1.0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dot_flops_per_chip_match_the_reference(reference, case):
    arch, kind, mesh = case
    want = reference[ref.cost_key(*case)]
    got = port_cost(*case)
    assert want["kind"] == kind
    assert got["num_partitions"] == want["num_partitions"] == math.prod(mesh)
    if math.prod(mesh) == 1 and (arch, kind) not in INEXACT:
        assert got["dot_flops_per_chip"] == want["dot_flops_per_chip"]
    else:
        assert abs(got["dot_flops_per_chip"]
                   / want["dot_flops_per_chip"] - 1) <= REL, (
            got["dot_flops_per_chip"], want["dot_flops_per_chip"])


def test_mamba2_train_gap_is_the_elementwise_factors_gradients(reference):
    """The chunked SSD scan's two three-operand einsums (chunk states
    ``w, x, B`` and inter-chunk outputs ``C, h, decay_in``) each take a
    gradient for their elementwise factor, a sum over the head dimension:
    XLA writes it as a dot, torch as a multiply and a sum, which counts no
    FLOPs. That is 2 x 2*B*nc*Q*nh*hd a layer, the whole gap."""
    cfg = get_reduced("mamba2-370m", layers=2, d_model=64, vocab=256)
    s = cfg.ssm
    nh, nc = s.n_heads(cfg.d_model), ref.COST_SEQ // s.chunk_size
    per_layer = 2 * (2 * ref.COST_BATCH * nc * s.chunk_size * nh
                     * s.headdim)
    want = reference[ref.cost_key("mamba2-370m", "train", (1, 1, 1))]
    got = port_cost("mamba2-370m", "train", (1, 1, 1))
    assert (want["dot_flops_per_chip"] - got["dot_flops_per_chip"]
            == cfg.n_layers * per_layer == 524288)


@pytest.mark.parametrize("arch", ref.COST_ARCHS)
def test_collectives_only_on_meshes_of_several_devices(reference, arch):
    for kind, mesh in ref.COST_CASES:
        got = port_cost(arch, kind, mesh)
        want = reference[ref.cost_key(arch, kind, mesh)]
        if math.prod(mesh) == 1:
            assert got["collective_total_per_chip"] == 0
            assert got["collective_op_counts"] == {}
            assert want["collective_total_per_chip"] == 0
        else:
            assert got["collective_total_per_chip"] > 0, (kind, mesh)
            assert want["collective_total_per_chip"] > 0, (kind, mesh)


def test_one_parameters_fsdp_gather_counted_by_hand():
    """On 1 x 4 x 1 a [64, 96] bf16 weight split over 'data' (its 'fsdp')
    is gathered once a forward pass, however often it is read:
    out * (g - 1) / g."""
    mesh = PS.abstract_mesh((1, 4, 1), AXES)
    w = torch.empty(64, 96, dtype=torch.bfloat16, device="meta")
    x = torch.empty(32, 64, dtype=torch.bfloat16, device="meta")
    with PS.sharding_scope(mesh, "2d"):
        spec = PS.resolve(("fsdp", "ffn"), shape=w.shape)
        xspec = PS.resolve(("batch", None), shape=x.shape)
    assert spec == ("data", "model")
    got = CA.trace(lambda: (x @ w, torch.relu(x @ w)), mesh, "2d",
                   params=[(w, spec)], inputs=[(x, xspec)])
    out = 64 * 96 * 2
    assert got["collective_op_counts"] == {"all-gather": 1}
    assert got["collective_payload_bytes_per_chip"] == {"all-gather": out}
    assert got["collective_wire_bytes_per_chip"] == {
        "all-gather": out * 3 / 4}
    assert got["dot_flops_per_chip"] == 2 * (2 * 32 * 64 * 96) / 4


def test_row_parallel_product_all_reduces_its_output_by_hand():
    """x [32, 96] split over 'model' on its contracted dimension times a
    weight [96, 64] split there too ('ffn'): each device holds a partial
    sum of the [32, 64] output, all-reduced: 2 * out * (g - 1) / g."""
    mesh = PS.abstract_mesh((1, 1, 4), AXES)
    w = torch.empty(96, 64, dtype=torch.bfloat16, device="meta")
    x = torch.empty(32, 96, dtype=torch.bfloat16, device="meta")
    got = CA.trace(lambda: x @ w, mesh, "2d",
                   params=[(w, ("model", "data"))],
                   inputs=[(x, (None, "model"))])
    out = 32 * 64 * 2
    assert got["collective_op_counts"] == {"all-reduce": 1}
    assert got["collective_wire_bytes_per_chip"] == {
        "all-reduce": 2 * out * 3 / 4}


def _ep_case(dtype=torch.float32, device="meta"):
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16)
    gen = torch.Generator().manual_seed(3)

    def w(*shape):
        t = torch.randn(*shape, generator=gen, dtype=torch.float32) * 0.2
        return t.to(dtype).to(device)

    p = {"router": w(32, 8), "wg": w(8, 32, 16), "wu": w(8, 32, 16),
         "wd": w(8, 16, 32)}
    return cfg, w(4, 8, 32), p


def _host_mesh(shape):
    return PS.HostMesh(np.full(shape, "cpu", dtype=object),
                       ("data", "model"))


def _ep_one_coordinate(mesh_shape) -> dict:
    cfg, x, p = _ep_case()
    return CA.trace(lambda: moe.moe_ffn(p, x, cfg),
                    PS.abstract_mesh(mesh_shape, ("data", "model")), "2d")


def test_expert_parallel_rank_sum_is_an_all_reduce_counted_by_hand():
    """Under 2 x 2 each coordinate sums its [T/2, d] f32 output over the
    two model ranks and averages its f32 aux over the two token shards:
    two all-reduces, 2 * out * (g - 1) / g each."""
    got = _ep_one_coordinate((2, 2))
    y_bytes, aux_bytes = (32 // 2) * 32 * 4, 4
    assert got["collective_op_counts"] == {"all-reduce": 2}
    assert got["collective_payload_bytes_per_chip"] == {
        "all-reduce": y_bytes + aux_bytes}
    assert got["collective_wire_bytes_per_chip"] == {
        "all-reduce": 2 * y_bytes / 2 + 2 * aux_bytes / 2}


def test_shard_map_loop_runs_n_ranks_times_one_coordinate():
    """seq_parallel_attention on a 2 x 2 HostMesh of the CPU (batch over
    'data', queries over 'model', a band of Sl + window keys a rank) runs
    every coordinate; the cost trace runs one. The loop's FLOPs are four
    times the one coordinate's: the bodies are alike."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 32, 4, 16, generator=gen) for _ in range(3))
    kw = dict(causal=True, window=8, impl="blockwise", block_kv=8)
    rules = PS.seq_attn_rules("2d")
    with PS.sharding_scope(_host_mesh((2, 2)), rules), \
            FlopCounterMode(display=False) as fc:
        layers.seq_parallel_attention(q, k, v, **kw)
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    one = CA.trace(lambda: layers.seq_parallel_attention(qm, km, vm, **kw),
                   PS.abstract_mesh((2, 2), ("data", "model")), rules)
    assert one["dot_flops_per_chip"] > 0
    assert fc.get_total_flops() == 4 * one["dot_flops_per_chip"]


def test_expert_parallel_loop_plus_skipped_routings_is_n_ranks_times_one():
    """On one process the HostMesh loop routes each token shard once for
    all its model ranks; a rank of a real mesh routes its shard itself.
    The loop's FLOPs plus the (n_model - 1) routings each shard skips
    equal four times one coordinate's."""
    cfg, x, p = _ep_case(device="cpu")
    with PS.sharding_scope(_host_mesh((2, 2)), "2d"), \
            FlopCounterMode(display=False) as fc:
        moe.moe_ffn(p, x, cfg)
    t_loc, d = x.shape[0] * x.shape[1] // 2, x.shape[2]
    routing = 2 * t_loc * d * cfg.n_experts
    one = _ep_one_coordinate((2, 2))["dot_flops_per_chip"]
    assert fc.get_total_flops() + (2 - 1) * 2 * routing == 4 * one


def test_shape_only_mesh_runs_one_coordinate_only_inside_a_trace():
    cfg, x, p = _ep_case()
    with PS.sharding_scope(PS.abstract_mesh((2, 2), ("data", "model"))):
        with pytest.raises(TypeError, match="places nothing"):
            moe.moe_ffn(p, x, cfg)
    with pytest.raises(TypeError, match="HostMesh runs every coordinate"):
        CA.trace(lambda: None, _host_mesh((1, 2)), "2d")


# --- named faults ----------------------------------------------------------

def mutant(module, name: str, edits):
    """``module.<name>`` rebuilt from its source with ``edits``, looking
    up the module's globals."""
    src = textwrap.dedent(inspect.getsource(getattr(module, name)))
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    code = compile(src, "<fault>", "exec")
    fn = next(c for c in code.co_consts if isinstance(c, types.CodeType))
    real = getattr(module, name)
    out = types.FunctionType(fn, vars(module), name, real.__defaults__)
    out.__kwdefaults__ = real.__kwdefaults__
    return out


FAULTS = {
    # every coordinate of a mapped region counted, summed
    "every_coordinate": (CA, "one_coordinate", (
        ("    for coord in coords:",
         "    for coord in [dict(zip(mesh.axis_names, i)) for i in "
         "__import__('itertools').product(*(range(mesh.shape[a]) "
         "for a in mesh.axis_names))]:"),
        ("        if best is None or acc.flops > best[0].flops:\n"
         "            best = (acc, outs)",
         "        if best is not None:\n"
         "            acc.add(best[0])\n"
         "        best = (acc, outs)"))),
    # the routing done once for all tokens outside the region, each
    # coordinate reusing its shard's, as the one-process loop does
    "route_once_per_token_shard": (moe, "_one_coordinate", (
        ("    def body(coord, x_b, router, *w):\n"
         "        top_p, top_i, aux = route(router, x_b, cfg)",
         "    routed = route(p['router'], xt, cfg)\n\n"
         "    def body(coord, x_b, router, *w):\n"
         "        top_p, top_i, aux = (t[:x_b.shape[0]] if t.dim() else t\n"
         "                             for t in routed)"),)),
    # expert_parallel's sum over the model ranks left out
    "no_rank_sum": (moe, "_one_coordinate", (
        ("        CA.record_collective(\"all-reduce\", y.numel() * "
         "y.element_size(),\n                             n_model)\n", ""),)),
}
FAULT_CASES = [("smollm-135m", "train", (2, 2, 2)),
               ("kimi-k2-1t-a32b", "train", (2, 2, 2)),
               ("kimi-k2-1t-a32b", "train", (1, 1, 4))]


@pytest.mark.parametrize("fault", ["every_coordinate",
                                   "route_once_per_token_shard"])
def test_named_fault_fails_the_flop_comparison(reference, monkeypatch,
                                                fault):
    module, name, edits = FAULTS[fault]
    monkeypatch.setattr(module, name, mutant(module, name, edits))
    offs = {ref.cost_key(*c): _off(reference, c) for c in FAULT_CASES}
    assert any(abs(o) > REL for o in offs.values()), offs


def test_leaving_out_the_rank_sum_fails_the_hand_count(monkeypatch):
    module, name, edits = FAULTS["no_rank_sum"]
    monkeypatch.setattr(module, name, mutant(module, name, edits))
    with pytest.raises(AssertionError):
        test_expert_parallel_rank_sum_is_an_all_reduce_counted_by_hand()


def test_mutants_without_edits_pass(reference, monkeypatch):
    plain = {(m, n): mutant(m, n, ()) for m, n, _ in FAULTS.values()}
    for (module, name), fn in plain.items():
        monkeypatch.setattr(module, name, fn)
    for case in FAULT_CASES:
        assert abs(_off(reference, case)) <= REL, case
    test_expert_parallel_rank_sum_is_an_all_reduce_counted_by_hand()


# --- lower_cell's kind and seq-attn switch on the production meshes --------

@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    arrs = ref.run_reference("layout", tmp_path_factory.mktemp("ref")
                             / "layout.npz",
                             host_devices=ref.LAYOUT_DEVICES)
    return json.loads(str(arrs["layout"]))


@pytest.mark.parametrize("rules", ref.LAYOUT_RULES)
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_lower_cell_kind_and_seq_attn_switch_match_the_reference(
        layout, multi_pod, rules):
    want = layout[f"{'pod2' if multi_pod else 'pod1'}|{rules}|cells"]
    base = PS.seq_attn_rules("2d") if rules == "seq_2d" else rules
    got = {}
    with PS.sharding_scope(make_production_mesh(multi_pod=multi_pod), base):
        _, scope_rules = PS.current_scope()
        for arch, shape, _ in cells(include_skips=True):
            low, kind = steps.lower_cell(get_config(arch),
                                         RunConfig(arch=arch), shape)
            assert low.rules in (scope_rules,
                                 PS.seq_attn_rules(scope_rules))
            got[f"{arch}|{shape.name}"] = [kind, low.rules != scope_rules]
    assert got == want
