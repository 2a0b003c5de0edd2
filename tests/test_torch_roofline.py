"""The port's roofline (``runtime/roofline.py``) against the reference's,
and the H100 peaks defined once, in ``cluster/topology.py``, on the CPU.

``model_flops`` is the reference's to the bit over every arch x shape;
``roofline_report`` gives the reference's numbers when both read the same
record with the reference's TPU constants; with the H100 defaults each
term is the arithmetic of ``topology.py``'s figures. ``chip_smoke.py``
reads its peaks from ``topology.py`` rather than repeating them.
"""
import pytest

import _torch_ref as ref
from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget_config
from repro.runtime import roofline as RR
from repro_torch.cluster import topology
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.runtime import roofline as R

CELLS = [(a, s.name) for a in ARCHS for s in SHAPES]


def _shape(shapes, name):
    return next(s for s in shapes if s.name == name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference_bit_for_bit(arch, shape):
    got = R.model_flops(get_config(arch), _shape(SHAPES, shape))
    want = RR.model_flops(rget_config(arch), _shape(RSHAPES, shape))
    assert got == want and type(got) is type(want)


# records of the dry run's layout: per-chip counts, chips on the mesh
RECORDS = (
    {"chips": 256, "hlo": {"dot_flops_per_chip": 3.1e15,
                           "mem_bytes_per_chip": 2.2e11,
                           "collective_total_per_chip": 4.7e10}},
    {"chips": 512, "hlo": {"dot_flops_per_chip": 5.5e12,
                           "mem_bytes_per_chip": 9.1e12,
                           "collective_total_per_chip": 1.0e9}},
    {"chips": 1, "hlo": {"dot_flops_per_chip": 0.0,
                         "mem_bytes_per_chip": 0.0,
                         "collective_total_per_chip": 0.0}},
)


@pytest.mark.parametrize("rec", range(len(RECORDS)))
@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("kimi-k2-1t-a32b", "prefill_32k"),
                                        ("mamba2-370m", "decode_32k")])
def test_report_equals_the_reference_on_its_constants(arch, shape, rec):
    record = RECORDS[rec]
    got = R.roofline_report(record, get_config(arch), _shape(SHAPES, shape),
                            peak_flops=RR.PEAK_FLOPS, hbm_bw=RR.HBM_BW,
                            link_bw=RR.ICI_BW)
    want = RR.roofline_report(record, rget_config(arch),
                              _shape(RSHAPES, shape))
    assert got == want


def test_h100_terms_are_topologys_arithmetic():
    rec = RECORDS[0]
    cfg, shape = get_config("smollm-135m"), _shape(SHAPES, "train_4k")
    got = R.roofline_report(rec, cfg, shape)
    hlo = rec["hlo"]
    assert got["t_compute_s"] == hlo["dot_flops_per_chip"] / 989e12
    assert got["t_memory_s"] == hlo["mem_bytes_per_chip"] / 3.35e12
    assert got["t_collective_s"] == hlo["collective_total_per_chip"] / 450e9
    assert got["bound"] == "compute"
    t_step = max(got["t_compute_s"], got["t_memory_s"],
                 got["t_collective_s"])
    assert got["roofline_fraction"] == (
        R.model_flops(cfg, shape) / rec["chips"] / 989e12) / t_step
    pod = topology.Pod("p", "s")
    assert (pod.chip_peak_flops, pod.chip_hbm_bps, pod.chip_link_bps) == (
        R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (
        topology.H100_BF16_FLOPS, topology.H100_HBM_BPS,
        topology.H100_NVLINK_BPS)


def test_chip_smoke_reads_its_peaks_from_topology():
    import chip_smoke
    assert chip_smoke.BF16_TC_FLOPS is topology.H100_BF16_FLOPS
    assert chip_smoke.F32_FLOPS is topology.H100_F32_FLOPS
    assert chip_smoke.F64_FLOPS is topology.H100_F64_FLOPS
    assert chip_smoke.HBM_BPS is topology.H100_HBM_BPS
    assert R.PEAK_FLOPS is topology.H100_BF16_FLOPS
    assert R.HBM_BW is topology.H100_HBM_BPS


def test_chip_smoke_phase_20_passes_on_reduced_cells(monkeypatch):
    """chip_smoke's phase 20 rehearsed on the CPU: reduced gemma3-12b's
    prefill and mamba2-370m's train step, each traced on meta tensors and
    run on real CPU tensors, whose FlopCounterMode count must equal the
    trace's (CUDA events stubbed, the card's memory measured on the CPU
    run, ``_torch_ref.rehearse_phase_20``)."""
    import chip_smoke
    ref.rehearse_phase_20(chip_smoke, monkeypatch)
    got = [chip_smoke.roofline_cell("gemma3-12b", "prefill", 2, 64, "blockwise",
                                     "cpu"),
           chip_smoke.roofline_cell("mamba2-370m", "train", 2, 64, "blockwise",
                                     "cpu")]
    for r in got:
        assert r["card_flops"] == r["dot_flops_per_chip"] > 0
        assert 0 < r["t_compute_ms"] <= r["measured_ms"] == 1e3
