"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's own (``repro/launch/dryrun.py``) on the production meshes, on
the CPU, and the two repairs of the cell cost that came before it.

The reference's ``main`` runs in a child process on 512 forced host
devices (``tests/_torch_ref.py::_child_dryrun``), its production meshes
built with ``jax.sharding.Mesh`` and its configs reduced (layers 2,
d_model 64, vocab 256; 16 experts for the MoE archs, which its MoE needs
on a 16-wide 'model' axis), on every cell of ``cells(include_skips=True)``
on 16 x 16 and on ``train_4k`` and ``decode_32k`` of three archs on 2 x 16
x 16. The port's ``main`` runs the same cells in this process with the
same configs. Per cell: the record's keys (less ``hlo.entry`` and
``hlo.n_computations``), kind, mesh, chips and skips are the reference's,
``memory.argument_bytes`` is its compiled ``argument_size_in_bytes`` to
the byte, and ``dot_flops_per_chip`` is its count, or differs by the
count pinned in FLOP_GAPS (PERF.md §6 names the ops).

Repair (a): blockwise attention remats each KV block as the reference's
``jax.checkpoint`` of its scan step does, so a blockwise train step counts
the reference's FLOPs (held to the child's compiled counts) and keeps no
block's probabilities for the backward. Repair (b): work that does not
split counts whole on every device (hand counts). Then the trace's live
bytes, and ``chip_smoke.py``'s phases 20 and 21 rehearsed at reduced size.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_ref as ref
from repro_torch.configs import cells, get_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.models import layers
from repro_torch.runtime import cost_analysis as CA
from repro_torch.runtime import pspec as PS
from repro_torch.runtime import steps

REPO = Path(__file__).resolve().parents[1]
CELLS = ref.dryrun_cells(cells)
NOT_HLO = ("entry", "n_computations")
# port - reference dot FLOPs per chip on the cells where they differ: XLA's
# own partitioning and algebraic choices that the trace does not model
# (PERF.md §6 names the ops); every other traced cell is equal
FLOP_GAPS = {
    # the MoE's always-on branches (arctic's dense residual, kimi-k2's
    # shared expert) count at counted_at's token split; XLA also splits
    # their products over the idle 'model' axis
    "arctic-480b|train_4k|16x16": 2028994560,
    "arctic-480b|decode_32k|16x16": 165120,
    "kimi-k2-1t-a32b|train_4k|16x16": 849346560,
    "kimi-k2-1t-a32b|decode_32k|16x16": 69120,
    "kimi-k2-1t-a32b|decode_32k|2x16x16": 34560,
    # Mamba-2 layers (mamba2, jamba's SSM layers): XLA splits the chunked
    # scan's einsums over 'model' where the port keeps the 8 heads whole
    # (train, prefill); at decode the port splits the state update's
    # contraction over 'model' twice where XLA splits it once
    "mamba2-370m|train_4k|16x16": 926941184,
    "mamba2-370m|prefill_32k|16x16": 385875968,
    "mamba2-370m|decode_32k|16x16": -4096,
    "mamba2-370m|long_500k|16x16": -96,
    "mamba2-370m|train_4k|2x16x16": 369098752,
    "mamba2-370m|decode_32k|2x16x16": -2048,
    "jamba-v0.1-52b|train_4k|16x16": 1189085184,
    "jamba-v0.1-52b|prefill_32k|16x16": 255852544,
    "jamba-v0.1-52b|decode_32k|16x16": -2048,
    # gemma3's local layers attend a 16-slot ring at decode, which XLA's
    # simplifier computes as multiplies and reductions, not dots
    "gemma3-12b|decode_32k|16x16": 1024,
    "gemma3-12b|long_500k|16x16": 120,
    # seamless: the encoder's attention and the cross-attention split
    # batch, heads and sequence over the mesh otherwise than XLA does
    "seamless-m4t-medium|train_4k|16x16": -19126026240,
    "seamless-m4t-medium|prefill_32k|16x16": -13891534848,
}
# port (flash) - reference (pallas) on the cells whose kernel path reaches
# a kernel (tests/test_torch_kernel_cost.py names the kinds): the reference
# runs every interpreted grid whole on each of 256 or 512 devices and
# recomputes the SSD's backward through its sequential oracle (train); the
# port's prefill runs the SSD kernel where the reference's runs its chunked
# jnp scan, and its seamless encoder splits otherwise (FLOP_GAPS)
KERNEL_FLOP_GAPS = {
    "mamba2-370m|train_4k|16x16": -20470300672,
    "mamba2-370m|prefill_32k|16x16": 142606336,
    "jamba-v0.1-52b|train_4k|16x16": -9207545856,
    "jamba-v0.1-52b|prefill_32k|16x16": 134217728,
    "seamless-m4t-medium|train_4k|16x16": -149854093312,
    "seamless-m4t-medium|prefill_32k|16x16": -516402708480,
    "mamba2-370m|train_4k|2x16x16": -21553479680,
}


def _key(cell) -> str:
    return ref.dryrun_key(*cell)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    arrs = ref.run_reference("dryrun", tmp_path_factory.mktemp("ref")
                             / "dryrun.npz", timeout=900,
                             host_devices=ref.DRYRUN_DEVICES)
    return json.loads(str(arrs["dryrun"]))


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(D, "get_config",
                        lambda arch: ref.dryrun_config(get_reduced, arch))


@pytest.fixture(scope="module")
def kernel_reference(tmp_path_factory):
    arrs = ref.run_reference("dryrun_kernel", tmp_path_factory.mktemp("ref")
                             / "dryrun_kernel.npz", timeout=600,
                             host_devices=ref.DRYRUN_DEVICES)
    return json.loads(str(arrs["dryrun_kernel"]))


def _main(argv, path: Path) -> tuple:
    rc = D.main(list(argv) + ["--json", str(path)])
    return rc, json.loads(path.read_text())


def _paths(rec, prefix=()):
    out = set()
    for k, v in rec.items():
        out.add(prefix + (k,))
        if isinstance(v, dict) and k not in ("collective_wire_bytes_per_chip",
                                             "collective_payload_bytes_per_chip",
                                             "collective_op_counts"):
            out |= _paths(v, prefix + (k,))
    return out


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_record_matches_the_references(reference, reduced, tmp_path, cell):
    arch, shape, multi_pod = cell
    want = reference[_key(cell)]
    rc, (got,) = _main(["--arch", arch, "--shape", shape]
                       + (["--multi-pod"] if multi_pod else []),
                       tmp_path / "cell.json")
    assert rc == 0
    if "skipped" in want:
        assert got == want
        return
    assert _paths(got) == {p for p in _paths(want)
                           if p not in {("hlo", k) for k in NOT_HLO}}
    for k in ("arch", "shape", "kind", "mesh", "chips"):
        assert got[k] == want[k], k
    assert got["hlo"]["num_partitions"] == want["hlo"]["num_partitions"]
    assert (got["memory"]["argument_bytes"]
            == want["memory"]["argument_bytes"])
    gap = (got["hlo"]["dot_flops_per_chip"]
           - want["hlo"]["dot_flops_per_chip"])
    assert gap == FLOP_GAPS.get(_key(cell), 0), gap
    assert got["cost_analysis"] == {
        "flops": got["hlo"]["dot_flops_per_chip"],
        "bytes accessed": got["hlo"]["mem_bytes_per_chip"]}


def test_all_cells_on_both_meshes_render_as_the_table(reduced, tmp_path):
    path = tmp_path / "all.json"
    rc, recs = _main(["--all", "--both-meshes"], path)
    assert rc == 0
    assert len(recs) == 80
    assert sum("skipped" in r for r in recs) == 14
    assert not any("error" in r for r in recs)
    assert {r["mesh"] for r in recs} == {"16x16", "2x16x16"}
    for mesh in ("16x16", "2x16x16"):
        out = subprocess.run([sys.executable,
                              str(REPO / "scripts" / "roofline_table.py"),
                              str(path), mesh], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        rows = out.stdout.splitlines()[2:]
        assert len(rows) == 40
        assert not any("ERROR" in r for r in rows)


def test_a_cell_that_raises_is_an_error_record(reduced, monkeypatch,
                                               tmp_path, capsys):
    real = D.get_shape

    def get_shape(name):
        if name == "prefill_32k":
            raise RuntimeError("no such cell today")
        return real(name)

    monkeypatch.setattr(D, "get_shape", get_shape)
    rc, recs = _main(["--arch", "smollm-135m", "--shape", "prefill_32k",
                      "--both-meshes"], tmp_path / "err.json")
    assert rc == 1
    assert recs == [{"arch": "smollm-135m", "shape": "prefill_32k",
                     "mesh": m, "error": "RuntimeError('no such cell "
                                         "today')"}
                    for m in ("16x16", "2x16x16")]
    assert "FAILURES (2):" in capsys.readouterr().out


@pytest.mark.parametrize("cell", ref.KERNEL_DRYRUN_CELLS, ids=_key)
def test_a_kernel_reaching_cell_traces_as_the_references_pallas(
        kernel_reference, reduced, tmp_path, cell):
    """Under ``--attn-impl flash`` a cell whose path reaches a kernel (the
    SSD scan, seamless's non-causal encoder) traces the kernels on meta
    tensors by their rules: no error record, the reference's keys and
    argument bytes, its ``pallas`` dot FLOPs or the pinned gap, and counts
    other than the blockwise path's."""
    arch, shape, multi_pod = cell
    argv = ["--arch", arch, "--shape", shape] + (
        ["--multi-pod"] if multi_pod else [])
    rc, (got,) = _main(argv + ["--attn-impl", "flash"], tmp_path / "f")
    want = kernel_reference[_key(cell)]
    assert rc == 0 and "error" not in got
    assert _paths(got) == {p for p in _paths(want)
                           if p not in {("hlo", k) for k in NOT_HLO}}
    assert got["kind"] == want["kind"]
    assert (got["memory"]["argument_bytes"]
            == want["memory"]["argument_bytes"])
    gap = (got["hlo"]["dot_flops_per_chip"]
           - want["hlo"]["dot_flops_per_chip"])
    assert gap == KERNEL_FLOP_GAPS[_key(cell)], gap
    _, (block,) = _main(argv, tmp_path / "b")
    assert got["hlo"]["dot_flops_per_chip"] \
        != block["hlo"]["dot_flops_per_chip"]


def test_flash_where_the_reference_goes_blockwise_counts_blockwise(
        reduced, tmp_path):
    """Under the production mesh smollm's train step attends sequence-
    parallel, where ``flash`` runs the blockwise path as the reference's
    ``pallas`` does: the same counts."""
    argv = ["--arch", "smollm-135m", "--shape", "train_4k"]
    rc, (flash,) = _main(argv + ["--attn-impl", "flash"], tmp_path / "f")
    assert rc == 0
    _, (block,) = _main(argv, tmp_path / "b")
    assert flash["hlo"] == block["hlo"]


# --- repair (a): blockwise attention remats each KV block ------------------

@pytest.fixture(scope="module")
def remat_reference(tmp_path_factory):
    arrs = ref.run_reference("remat", tmp_path_factory.mktemp("ref")
                             / "remat.npz", timeout=600)
    return json.loads(str(arrs["remat"]))


def _train_flops(seq: int, remat: str, impl: str = "blockwise") -> float:
    cfg = get_reduced("smollm-135m", **ref.DRYRUN_REDUCED)
    run = RunConfig(arch="smollm-135m", remat=remat, attn_impl=impl)
    shape = ShapeConfig("t", seq_len=seq, global_batch=ref.REMAT_BATCH,
                        kind="train")
    with PS.sharding_scope(PS.abstract_mesh((1, 1, 1),
                                            ("pod", "data", "model")),
                           run.sharding):
        low, _ = steps.lower_cell(cfg, run, shape)
    return CA.analyze_cell(low)["dot_flops_per_chip"]


@pytest.mark.parametrize("remat", ref.REMAT_MODES)
@pytest.mark.parametrize("seq", ref.REMAT_SEQS)
def test_blockwise_train_step_counts_the_references_flops(remat_reference,
                                                          seq, remat):
    """Up to one KV block (seq 1024) nothing is recomputed, as the
    reference's compiled trip-1 scan; from two blocks each block's
    ``QK^T`` is recomputed once in the backward, its ``p @ v`` not."""
    got = _train_flops(seq, remat)
    assert got == remat_reference[ref.remat_key(seq, remat)]
    if seq <= 1024:
        assert got == _train_flops(seq, remat, impl="naive")


def _qkv(T=512, nq=4, nkv=2, h=16, seed=3, **kw):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(1, T, n, h, generator=gen, **kw)
            for n in (nq, nkv, nkv)]


def _saved_bytes(block_kv: int, T: int = 512) -> tuple:
    """Bytes that autograd's saved-tensor hooks pack in one blockwise
    attention forward, and the largest tensor packed."""
    q, k, v = (t.requires_grad_() for t in _qkv(T))
    packed = []

    def pack(t):
        packed.append(t.numel() * t.element_size())
        return t

    pos = torch.arange(T)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        layers.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                         impl="blockwise", block_kv=block_kv)
    return sum(packed), max(packed)


def test_one_layer_saves_no_block_probabilities():
    """At T = S = 512 over blocks of 64 the backward saves nothing of
    size T x block (a block's scores or probabilities, f32 per head),
    let alone T x S; a single block of 512 saves its T x S probabilities,
    as it always did."""
    T, bk, nq = 512, 64, 4
    total, largest = _saved_bytes(bk, T)
    assert largest < nq * T * bk * 4
    assert total < nq * T * T * 4
    _, one_block = _saved_bytes(T, T)
    assert one_block >= nq * T * T * 4


def test_one_layer_holds_o_t_block_live_bytes_for_backward():
    """The trace's live bytes after a blockwise forward on meta tensors
    (what the graph keeps for the backward): with the per-block remat,
    each block's carry (m, l and acc: T x h) and no probabilities, under a
    third of one T x S f32 score matrix; with the checkpoint taken out,
    the eight blocks' probabilities and more, over eight times as much."""
    T, bk, nq = 512, 64, 4
    q, k, v = (t.to("meta").requires_grad_() for t in _qkv(T))
    pos = torch.arange(T, device="meta")
    held = {}

    def fwd(name):
        def fn():
            tr = CA.active()
            base = tr.live
            out = layers.attention(q, k, v, q_pos=pos, kv_pos=pos,
                                   causal=True, impl="blockwise",
                                   block_kv=bk)
            held[name] = tr.live - base - out.numel() * out.element_size()
        return fn

    CA.trace(fwd("remat"), None, None)
    real = layers.checkpoint
    try:
        layers.checkpoint = lambda f, *a, **kw: f(*a)
        CA.trace(fwd("none"), None, None)
    finally:
        layers.checkpoint = real
    assert 3 * held["remat"] < nq * T * T * 4 <= held["none"]
    assert 8 * held["remat"] < held["none"]


def test_blockwise_gradients_equal_the_naive_paths():
    """f32, three blocks of 32 over 96 keys, causal with a window of 40:
    the output and the gradients of q, k and v within 1e-5 of the naive
    path's largest value."""
    q, k, v = (t.requires_grad_() for t in _qkv(96, seed=7))
    pos = torch.arange(96)
    cot = torch.randn(1, 96, 4, 16, generator=torch.Generator()
                      .manual_seed(8))
    got = {}
    for impl in ("naive", "blockwise"):
        out = layers.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                               window=40, impl=impl, block_kv=32)
        grads = torch.autograd.grad((out * cot).sum(), (q, k, v))
        got[impl] = (out.detach(),) + grads
    for a, b in zip(got["blockwise"], got["naive"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# --- repair (b): work that does not split counts whole ---------------------

def test_a_product_replicated_over_model_counts_whole_per_device():
    """On 1 x 16 an x [32, 64] and a weight [64, 96] that no layout
    splits: every device runs the whole product, 2 * 32 * 64 * 96."""
    mesh = PS.abstract_mesh((1, 16), ("data", "model"))
    w = torch.empty(64, 96, device="meta")
    x = torch.empty(32, 64, device="meta")
    got = CA.trace(lambda: x @ w, mesh, "2d", params=[(w, (None, None))],
                   inputs=[(x, (None, None))])
    assert got["dot_flops_per_chip"] == 2 * 32 * 64 * 96


def test_a_batch_of_one_over_data_counts_whole_per_device():
    """On 16 x 1 a batch of one does not split over 'data'
    (``resolve`` drops the axis): the product [1, 8, 64] x [64, 96] counts
    whole on every device, not a sixteenth of it."""
    mesh = PS.abstract_mesh((16, 1), ("data", "model"))
    x = torch.empty(1, 8, 64, device="meta")
    w = torch.empty(64, 96, device="meta")
    with PS.sharding_scope(mesh, "2d"):
        spec = PS.resolve(("batch", None, None), shape=x.shape)
    assert spec == (None, None, None)
    got = CA.trace(lambda: x @ w, mesh, "2d", params=[(w, (None, None))],
                   inputs=[(x, spec)])
    assert got["dot_flops_per_chip"] == 2 * 8 * 64 * 96


# --- the trace's live bytes -------------------------------------------------

def test_a_tensor_saved_for_backward_stays_counted_until_backward():
    """``exp`` saves its output: after the last Python name of that output
    is gone its storage is still live (autograd holds it), and it is taken
    back once ``autograd.grad`` has run."""
    x = torch.empty(64, 64, device="meta", requires_grad=True)
    seen = {}

    def fn():
        tr = CA.active()
        y = torch.exp(x)
        z = y.sum()
        seen["named"] = tr.live
        del y
        seen["saved"] = tr.live
        torch.autograd.grad(z, x)
        seen["after"] = tr.live

    CA.trace(fn, None, None)
    assert seen["named"] == 64 * 64 * 4 + 4
    assert seen["saved"] == seen["named"]
    assert seen["after"] == 4


# --- chip_smoke.py's phases 20 and 21 at reduced size -----------------------

def test_chip_smoke_phase_20_memory_gate_on_reduced_cells(monkeypatch):
    """Phase 20's memory gate at reduced size: the CPU run's storages
    (the step's arguments, and the most the step allocates over them)
    against the meta trace's ``argument_bytes + temp_bytes``, within the
    gate; a card peak twice the trace's fails it."""
    import chip_smoke
    ref.rehearse_phase_20(chip_smoke, monkeypatch)
    got = [chip_smoke.roofline_cell("mamba2-370m", "train", 2, 64,
                                    "blockwise", "cpu"),
           chip_smoke.roofline_cell("gemma3-12b", "prefill", 2, 64,
                                    "blockwise", "cpu")]
    lo, hi = chip_smoke.PEAK_RATIO_BOUNDS
    for r in got:
        assert lo <= r["peak_ratio"] <= hi, r
        assert r["card_flops"] == r["dot_flops_per_chip"] > 0
    peak = got[0]["trace_peak_bytes"]
    monkeypatch.setattr(chip_smoke, "card_memory",
                        lambda call: (0, 2 * peak))
    with pytest.raises(RuntimeError, match="outside"):
        chip_smoke.roofline_cell("mamba2-370m", "train", 2, 64, "blockwise",
                                 "cpu")


def test_chip_smoke_phase_20_flash_cells_on_reduced_cells(monkeypatch):
    """Phase 20's kernel-path cells at reduced size: the flash kernel in
    gemma3's prefill, the SSD kernel's forward (and its remat) with the
    plain backward in mamba2's step. The FlopCounterMode count equals the
    trace's, the memory gate holds, and each kernel's launches in the
    counted call equal its custom-op calls in the trace (the CPU
    rehearsal counts the wrappers' CPU calls as launches); a kernel that
    launched once more than the trace calls it fails the gate."""
    import chip_smoke
    from repro_torch.kernels import ssd_scan as ssd
    ref.rehearse_phase_20(chip_smoke, monkeypatch)
    got = [chip_smoke.roofline_cell("gemma3-12b", "prefill", 2, 64, "flash",
                                    "cpu"),
           chip_smoke.roofline_cell("mamba2-370m", "train", 2, 64, "flash",
                                    "cpu")]
    lo, hi = chip_smoke.PEAK_RATIO_BOUNDS
    for r in got:
        assert r["card_flops"] == r["dot_flops_per_chip"] > 0
        assert lo <= r["peak_ratio"] <= hi, r
        assert {n: k for n, k in r["launches"].items() if k} \
            == r["trace_kernel_calls"]
    assert got[0]["launches"] == {"flash_attention": 2, "ssd_scan": 0}
    assert got[1]["launches"] == {"flash_attention": 0, "ssd_scan": 4}
    assert chip_smoke.roofline_paths(got) == (
        {"20 roofline gemma3-12b prefill": 2},
        {"20 roofline mamba2-370m train": 4})
    inner = ssd.ssd_scan

    def one_more(*args, **kwargs):
        # the first call after each reset counts two launches
        if args[0].device.type == "cpu":
            one_more.launches += 1 + (one_more.launches == 0)
        return inner(*args, **kwargs)

    one_more.launches = 0
    monkeypatch.setattr(ssd, "ssd_scan", one_more)
    with pytest.raises(RuntimeError, match="launched"):
        chip_smoke.roofline_cell("mamba2-370m", "train", 2, 64, "flash",
                                 "cpu")


def _reduced_python(tmp_path: Path) -> str:
    """An interpreter for phase 21's subprocesses whose dry run traces the
    reduced configs; any other command runs as it is."""
    wrapper = tmp_path / "python"
    wrapper.write_text(
        "#!/bin/sh\n"
        "if [ \"$1\" = \"-m\" ]; then shift 2; exec " + sys.executable
        + " -c 'import sys; sys.path.insert(0, \"" + str(REPO / "tests")
        + "\"); import _torch_ref as ref; from repro_torch.configs import "
        "get_reduced; from repro_torch.launch import dryrun as D; "
        "D.get_config = lambda a: ref.dryrun_config(get_reduced, a); "
        "sys.exit(D.main(sys.argv[1:]))' \"$@\"; fi\n"
        "exec " + sys.executable + " \"$@\"\n")
    wrapper.chmod(0o755)
    return str(wrapper)


def test_chip_smoke_phase_21_runs_the_dry_run_at_reduced_size(tmp_path,
                                                              capsys):
    import chip_smoke
    recs = chip_smoke.dryrun_phase(tmp_path,
                                   python=_reduced_python(tmp_path))
    assert len(recs) == 6
    assert {(r["arch"], r["shape"], r["mesh"]) for r in recs} == {
        (a, s, m) for a, s, _ in chip_smoke.DRYRUN_CELLS
        for m in chip_smoke.DRYRUN_MESHES}
    out = capsys.readouterr().out
    assert out.count('"dryrun_cell"') == 6


def test_chip_smoke_phase_21_flash_cell_counts_the_ssd_kernel(
        reduced, tmp_path, monkeypatch, capsys):
    """Phase 21's kernel-path cell, mamba2's ``train_4k`` under ``--attn-impl
    flash``, beside its blockwise run: on both meshes the subprocess's
    records are ``run_cell``'s on the kernel path, whose dot FLOPs are not
    the blockwise path's."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS", (
        ("mamba2-370m", "train_4k", "blockwise"),
        ("mamba2-370m", "train_4k", "flash")))
    recs = chip_smoke.dryrun_phase(tmp_path,
                                   python=_reduced_python(tmp_path))
    assert '"attn_impl": "flash"' in capsys.readouterr().out
    block, flash = recs[:2], recs[2:]
    for b, f in zip(block, flash):
        want = D.run_cell("mamba2-370m", "train_4k",
                          multi_pod=f["mesh"] == "2x16x16", verbose=False,
                          run_overrides={"attn_impl": "flash"})
        assert f["hlo"] == want["hlo"] and f["memory"] == want["memory"]
        assert f["mesh"] == b["mesh"]
        assert f["hlo"]["dot_flops_per_chip"] \
            != b["hlo"]["dot_flops_per_chip"]


def test_chip_smoke_phase_21_fails_on_a_missing_key(tmp_path, monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DRYRUN_KEYS",
                        chip_smoke.DRYRUN_KEYS + ("no_such_key",))
    with pytest.raises(RuntimeError, match="no_such_key"):
        chip_smoke.dryrun_phase(tmp_path, python=_reduced_python(tmp_path))
