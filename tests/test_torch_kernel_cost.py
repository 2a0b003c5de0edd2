"""The kernel path's cell cost (``attn_impl="flash"``: the flash and SSD
kernels as the custom ops ``repro_torch::flash_fwd`` and
``repro_torch::ssd_scan_fwd``, counted on meta tensors by the rules beside
them) against the reference's compiled counts of its ``pallas`` path, on
the CPU.

The reference lowers and compiles its Pallas kernels in interpret mode in
two child processes on 8 forced host devices
(``tests/_torch_ref.py::_child_cost_kernel``): each kernel called alone,
and the reduced cells of ``KERNEL_COST_ARCHS`` (layers 2, d_model 64,
vocab 256, seq 192 x batch 8; MoE at 16 experts) on every
``KERNEL_COST_CASES`` mesh. Each rule equals the reference's count of its
kernel alone. Argument bytes are equal on every cell, and dot FLOPs per
chip are equal or differ by the count pinned in KERNEL_GAPS, three of
whose kinds are derived here by hand. Named faults fail the comparison,
and the fakes allocate what the CUDA wrappers allocate.
"""
import concurrent.futures
import json
import re
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      shape_wrapper)

import _torch_ref as ref
from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.runtime import cost_analysis as CA
from repro_torch.runtime import pspec as PS
from repro_torch.runtime import steps

REPO = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
CASES = [(a, k, m) for a in ref.KERNEL_COST_ARCHS
         for k, m in ref.KERNEL_COST_CASES]
# port - reference dot FLOPs per chip where they differ (PERF.md §6):
# (a) train, one device: the plain recompute in a kernel's backward
#     computes the forward's output, which the backward does not read:
#     XLA drops it (flash: each layer's p @ v), torch runs it; the SSD's
#     backward recomputes through the chunked scan here, through the
#     sequential oracle there (kernels/ops.py says why);
# (b) every mesh of several devices: XLA cannot split the interpreter's
#     grid loop, so every device runs the whole grid, where the port's
#     kernel splits as its batch and heads do;
# (c) prefill: the port's SSM prefill runs the SSD kernel, counted by its
#     grid (C B^T once a head), the reference's its chunked jnp scan (C B^T
#     once a group).
# The other cases are equal; smollm's and kimi-k2's train steps on 2 x 2 x
# 2 and 1 x 1 x 4 attend sequence-parallel, blockwise on both sides.
KERNEL_GAPS = {
    "smollm-135m|train|1x1x1": 75497472,
    "smollm-135m|train|1x4x1": -383778816,
    "kimi-k2-1t-a32b|train|1x1x1": 75497472,
    "kimi-k2-1t-a32b|train|1x4x1": -383778816,
    "mamba2-370m|train|1x1x1": 121896960,
    "mamba2-370m|train|2x2x2": -66551808,
    "mamba2-370m|train|1x1x4": 81199104,
    "mamba2-370m|train|1x4x1": -82771968,
    "mamba2-370m|prefill|1x1x1": 22020096,
    "mamba2-370m|prefill|2x2x2": 2752512,
    "seamless-m4t-medium|train|1x1x1": 123994112,
    "seamless-m4t-medium|train|2x2x2": -518750208,
    "seamless-m4t-medium|train|1x1x4": -431161344,
    "seamless-m4t-medium|train|1x4x1": -433520640,
    "seamless-m4t-medium|prefill|2x2x2": -264241152,
    "jamba-v0.1-52b|train|1x1x1": 98697216,
    "jamba-v0.1-52b|train|2x2x2": -33275904,
    "jamba-v0.1-52b|train|1x1x4": 40009728,
    "jamba-v0.1-52b|train|1x4x1": -233275392,
    "jamba-v0.1-52b|prefill|1x1x1": 11010048,
    "jamba-v0.1-52b|prefill|2x2x2": 1376256,
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    where = tmp_path_factory.mktemp("ref")

    def run(group):
        return ref.run_reference(f"cost_kernel_{group}",
                                 where / f"{group}.npz", timeout=600,
                                 host_devices=ref.COST_DEVICES)

    got = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for arrs in pool.map(run, ref.KERNEL_COST_GROUPS):
            got.update(json.loads(str(arrs["cost_kernel"])))
    return got


def lower(arch: str, kind: str, mesh, impl: str = "flash"
          ) -> steps.LoweredCell:
    cfg = ref.dryrun_config(get_reduced, arch)
    run = RunConfig(arch=arch, multi_pod=True, attn_impl=impl)
    shape = ShapeConfig("t", seq_len=ref.KERNEL_COST_SEQ,
                        global_batch=ref.COST_BATCH, kind=kind)
    with PS.sharding_scope(PS.abstract_mesh(mesh, AXES), run.sharding):
        low, got = steps.lower_cell(cfg, run, shape)
    assert got == kind == low.kind
    return low


def port_cost(arch: str, kind: str, mesh) -> tuple:
    """(counts, memory, kernel calls) of the port's kernel path."""
    calls: dict = {}
    hlo, mem = CA.analyze(lower(arch, kind, mesh), calls)
    return hlo, mem, calls


def _gap(reference, case) -> int:
    want = reference[ref.cost_key(*case)]["dot_flops_per_chip"]
    return int(port_cost(*case)[0]["dot_flops_per_chip"] - want)


def _holds(reference, case) -> bool:
    """The comparison the cost is held to: its pinned gap, or none."""
    return _gap(reference, case) == KERNEL_GAPS.get(ref.cost_key(*case), 0)


# --- each rule against the reference's count of its kernel alone -----------

@pytest.mark.parametrize("case", ref.KERNEL_FLASH_CALLS,
                         ids=lambda c: ref.kernel_call_key("flash", c))
def test_flash_rule_counts_the_references_pallas_grid(reference, case):
    """Every point of the grid over T and S padded to 128, the blocks
    ``pl.when`` skips included."""
    b, t, s, hq, hkv, d, _, _ = case
    flops, nbytes = fa.flash_cost((b, t, hq, d), (b, s, hkv, d))
    assert flops == reference[ref.kernel_call_key("flash", case)]
    assert nbytes == 2 * (2 * b * t * hq * d + 2 * b * s * hkv * d)


@pytest.mark.parametrize("case", ref.KERNEL_SSD_CALLS,
                         ids=lambda c: ref.kernel_call_key("ssd", c))
def test_ssd_rule_counts_the_references_pallas_grid(reference, case):
    b, s, nh, hd, n, q = case
    flops, nbytes = ssd.ssd_cost((b, s, nh, hd), n, q)
    assert flops == reference[ref.kernel_call_key("ssd", case)]
    assert nbytes == (2 * (2 * b * s * nh * hd + 2 * b * s * n)
                      + 4 * (b * s * nh + nh + b * nh * hd * n))


def test_rules_by_hand_at_one_small_shape():
    """flash: B 1, T = S = 130 (two 128-blocks each), 2 heads of 16: 2 x 2
    x 2 grid points of 2 * 2 * 128 * 128 * 16. SSD: B 1, S 128, 2 heads of
    16, N 16, chunk 64: 1 x 2 x 2 points of 2*64*64*16 + 2*64*64*16 + 4 *
    64*16*16."""
    assert fa.flash_cost((1, 130, 2, 16), (1, 130, 2, 16))[0] \
        == 8 * 2 * 2 * 128 * 128 * 16 == 8388608
    assert ssd.ssd_cost((1, 128, 2, 16), 16, 64)[0] \
        == 4 * (2 * 64 * 64 * 16 * 2 + 4 * 64 * 16 * 16) == 1310720


def test_the_references_grid_runs_whole_on_every_device(reference):
    """The first flash call with 4 x its batch split over 4 devices: each
    device's count is the whole grid's (XLA gathers the operands and runs
    every trip of the interpreter's loop), four times the call's alone."""
    b, t, s, hq, hkv, d, _, _ = ref.KERNEL_FLASH_CALLS[0]
    whole = fa.flash_cost((4 * b, t, hq, d), (4 * b, s, hkv, d))[0]
    one = reference[ref.kernel_call_key("flash", ref.KERNEL_FLASH_CALLS[0])]
    assert reference["flash_batch_over_4"] == whole == 4 * one


def test_the_card_flop_counter_counts_each_kernel_by_its_rule():
    """``FlopCounterMode`` counts a kernel's op by its registered rule
    (here on CPU tensors, the plain versions inside), as the meta trace
    does."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 130, 2, 16, generator=gen)
    x = torch.randn(1, 128, 2, 16, generator=gen)
    dt = torch.rand(1, 128, 2, generator=gen)
    bc = torch.randn(1, 128, 1, 16, generator=gen)
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention(q, q, q)
    assert fc.get_total_flops() == fa.flash_cost(q.shape, q.shape)[0]
    with FlopCounterMode(display=False) as fc:
        ssd.ssd_scan(x, dt, -torch.ones(2), bc, bc, 64)
    assert fc.get_total_flops() == ssd.ssd_cost(x.shape, 16, 64)[0]


# --- the cells -------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: ref.cost_key(*c))
def test_kernel_path_cost_matches_the_references_pallas(reference, case):
    arch, kind, mesh = case
    want = reference[ref.cost_key(*case)]
    hlo, mem, calls = port_cost(*case)
    assert want["kind"] == kind
    assert hlo["num_partitions"] == want["num_partitions"]
    assert mem["argument_bytes"] == want["argument_bytes"]
    gap = hlo["dot_flops_per_chip"] - want["dot_flops_per_chip"]
    assert gap == KERNEL_GAPS.get(ref.cost_key(*case), 0), gap
    if mesh == (1, 1, 1):                # unmeshed: every layer's kernel
        assert calls, calls


def test_flash_gap_on_one_device_is_the_recomputes_unread_output(reference):
    """Gap (a) on smollm: the backward's plain recompute runs ``p @ v``, 2
    T S d a head, whose output it never reads; XLA drops it."""
    cfg = ref.dryrun_config(get_reduced, "smollm-135m")
    b, t = ref.COST_BATCH, ref.KERNEL_COST_SEQ
    pv = 2 * b * cfg.n_heads * t * t * cfg.d_head
    assert _gap(reference, ("smollm-135m", "train", (1, 1, 1))) \
        == cfg.n_layers * pv == 75497472


def test_flash_gap_over_data_is_the_grid_run_whole(reference):
    """Gap (b) on smollm's 1 x 4 x 1 train step: the port splits each of
    its four kernel calls (two layers, each recomputed by the remat) and
    the recompute's ``p @ v`` over the 4 batch shards; the reference runs
    every call's whole grid on each device."""
    cfg = ref.dryrun_config(get_reduced, "smollm-135m")
    b, t = ref.COST_BATCH, ref.KERNEL_COST_SEQ
    shape = (b, t, cfg.n_heads, cfg.d_head)
    kernel = fa.flash_cost(shape, shape)[0]
    pv = 2 * b * cfg.n_heads * t * t * cfg.d_head
    _, _, calls = port_cost("smollm-135m", "train", (1, 4, 1))
    assert calls == {"flash_attention": 2 * cfg.n_layers}
    assert _gap(reference, ("smollm-135m", "train", (1, 4, 1))) \
        == cfg.n_layers * pv // 4 - 2 * cfg.n_layers * kernel * 3 // 4


def test_ssd_prefill_gap_is_c_b_once_a_head(reference):
    """Gap (c) on mamba2: the kernel's grid counts C Bᵀ, 2 Q² N a chunk,
    for each of nh heads; the reference's chunked prefill once for its one
    group."""
    cfg = ref.dryrun_config(get_reduced, "mamba2-370m")
    s = cfg.ssm
    nh, q = s.n_heads(cfg.d_model), s.chunk_size
    nc = ref.KERNEL_COST_SEQ // q
    per_layer = 2 * ref.COST_BATCH * nc * q * q * s.d_state * (nh - 1)
    assert _gap(reference, ("mamba2-370m", "prefill", (1, 1, 1))) \
        == cfg.n_layers * per_layer == 22020096


# --- named faults fail the comparison --------------------------------------

def _card_blocks_flops(q_shape, k_shape, causal, window, *args, **kwargs):
    """What the Hopper kernel visits under a causal mask: the 128-blocks on
    and below the diagonal only."""
    B, T, Hq, d = q_shape
    n = -(-T // fa.COUNT_BLOCK)
    blocks = n * (n + 1) // 2 if causal else n * n
    return 2 * 2 * B * Hq * blocks * fa.COUNT_BLOCK ** 2 * d


def _no_recompute(ctx, g):
    q, k, v = ctx.saved_tensors
    return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v), \
        None, None


FAULTS = {
    "causal_blocks_only": lambda mp: mp.setitem(
        flop_registry, torch.ops.repro_torch.flash_fwd,
        shape_wrapper(_card_blocks_flops)),
    "no_backward_recompute": lambda mp: mp.setattr(
        ops._FlashAttention, "backward", staticmethod(_no_recompute)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_fails_the_comparison(reference, monkeypatch, fault):
    cases = [("smollm-135m", "prefill", (1, 1, 1)),
             ("smollm-135m", "train", (1, 1, 1))]
    assert all(_holds(reference, c) for c in cases)
    FAULTS[fault](monkeypatch)
    assert not all(_holds(reference, c) for c in cases)


# --- the fakes and the SSD scratch -------------------------------------------

def source_workspace_bytes(*dims, kind: str = "Workspace") -> int:
    """``workspace(...).total`` of ``csrc/ssd_scan.cu`` (``kind``
    ``"BwdWorkspace"``: ``bwd_workspace(...).total``, the backward's),
    evaluated from the source's own statements (``align256`` and the
    function)."""
    src = (REPO / "src" / "repro_torch" / "csrc" / "ssd_scan.cu").read_text()
    align = re.search(r"size_t align256\(size_t v\) \{ return (.*?); \}",
                      src).group(1)
    fn = "bwd_workspace" if kind == "BwdWorkspace" else "workspace"
    body = re.search(kind + r" " + fn + r"\(int batch, int seq, int n_heads,"
                     r"\s+int hd, int n,\s+int q\) \{\n(.*?)\n\}", src,
                     re.S).group(1)
    env = dict(zip(("batch", "seq", "n_heads", "hd", "n", "q"), dims))
    env["align256"] = lambda v: eval(align.replace("~size_t(255)", "~255"),
                                     {"v": v})
    for line in body.splitlines():
        line = line.strip().rstrip(";")
        if line in (f"{kind} w", "return w"):
            continue
        line = (line.replace("const size_t ", "").replace("(size_t)", "")
                .replace("sizeof(float)", "4").replace("w.", "w_")
                .replace(" / ", " // "))
        exec(line, env)
    return env["w_total"]


SCRATCH_SHAPES = [(8, 2048, 32, 64, 128, 256),    # mamba2-370m training
                  (4, 2048, 128, 64, 16, 256),    # jamba prefill
                  (2, 192, 8, 16, 16, 32), (1, 320, 3, 16, 16, 64)]


def _fake_allocations_ok(dims) -> bool:
    """The fake's y, h and scratch on meta: the shapes, dtypes and bytes
    the CUDA wrapper allocates (its scratch by the kernel source)."""
    b, s, nh, hd, n, q = dims
    meta = dict(device="meta")
    got = torch.ops.repro_torch.ssd_scan_fwd(
        torch.empty(b, s, nh, hd, dtype=torch.bfloat16, **meta),
        torch.empty(b, s, nh, **meta), torch.empty(nh, **meta),
        torch.empty(b, s, 1, n, dtype=torch.bfloat16, **meta),
        torch.empty(b, s, 1, n, dtype=torch.bfloat16, **meta), q)
    want = [((b, s, nh, hd), torch.bfloat16), ((b, nh, hd, n), torch.float32),
            ((source_workspace_bytes(*dims),), torch.uint8)]
    return [(tuple(t.shape), t.dtype) for t in got] == want


@pytest.mark.parametrize("dims", SCRATCH_SHAPES, ids=str)
def test_ssd_fake_allocates_what_the_cuda_wrapper_allocates(dims):
    assert ssd.workspace_bytes(*dims) == source_workspace_bytes(*dims)
    assert _fake_allocations_ok(dims)


@pytest.mark.parametrize("dims", SCRATCH_SHAPES, ids=str)
def test_ssd_backward_scratch_is_what_the_kernel_source_sizes(dims):
    """``bwd_workspace_bytes``, which phase 20 reads for the memory the
    backward kernels hold, against ``bwd_workspace(...).total`` of the
    source, and apart from the forward's."""
    want = source_workspace_bytes(*dims, kind="BwdWorkspace")
    assert ssd.bwd_workspace_bytes(*dims) == want
    assert want != source_workspace_bytes(*dims)


def test_scratch_sized_other_than_its_twin_fails(monkeypatch):
    dims = SCRATCH_SHAPES[0]
    assert _fake_allocations_ok(dims)
    # the scratch without the per-head cumulative sums
    monkeypatch.setattr(ssd, "workspace_bytes",
                        lambda b, s, nh, hd, n, q: 4 * b * (s // q) * (
                            q * q + nh * hd * n))
    assert not _fake_allocations_ok(dims)


def test_flash_fake_allocates_what_the_cuda_wrapper_allocates():
    q = torch.empty(4, 2048, 16, 240, dtype=torch.bfloat16, device="meta")
    k = torch.empty(4, 2048, 8, 240, dtype=torch.bfloat16, device="meta")
    before = fa.flash_attention.launches
    o = fa.flash_attention(q, k, k, causal=True, window=1024)
    assert (o.device.type, tuple(o.shape), o.dtype, o.is_contiguous()) == (
        "meta", (4, 2048, 16, 240), torch.bfloat16, True)
    assert fa.flash_attention.launches == before


def test_the_trace_holds_the_scratch_while_the_op_returns():
    """The trace's peak over one meta SSD call: y, h and the scratch at
    once (the scratch dies when the wrapper returns)."""
    b, s, nh, hd, n, q = SCRATCH_SHAPES[2]
    x = torch.empty(b, s, nh, hd, dtype=torch.bfloat16, device="meta")
    bc = torch.empty(b, s, 1, n, dtype=torch.bfloat16, device="meta")
    dt = torch.empty(b, s, nh, device="meta")
    a = torch.empty(nh, device="meta")
    seen = {}

    def fn():
        y, h = ssd.ssd_scan(x, dt, a, bc, bc, q)
        seen["live"] = CA.active().live
        seen["peak"] = CA.active().peak

    CA.trace(fn, None, None)
    y_h = 2 * b * s * nh * hd + 4 * b * nh * hd * n
    assert seen["live"] == y_h
    assert seen["peak"] == y_h + ssd.workspace_bytes(*SCRATCH_SHAPES[2])


@pytest.mark.gpu
def test_workspace_twin_equals_the_librarys_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library is built there")
    lib = ssd._library()
    for dims in SCRATCH_SHAPES:
        assert lib.ssd_scan_workspace_bytes(*dims) == ssd.workspace_bytes(
            *dims)
