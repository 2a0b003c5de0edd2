"""The frozen work counts against counts worked out by hand or by loops
at small shapes, and the model FLOPs against the port's parameter count."""
import json
import math

import pytest

from cellbench.bench import ROOT
from cellbench.counts.flash import band_pairs, flash_work
from cellbench.counts.model import flops_per_token
from cellbench.counts.ssd import ssd_work


def loop_pairs(T, S, causal, window):
    return sum(1 for i in range(T) for j in range(S)
               if (not causal or j <= i)
               and (window is None or i - j < window))


@pytest.mark.parametrize("T,S,causal,window,want", [
    (5, 5, True, None, 15),            # 1 + 2 + 3 + 4 + 5
    (5, 5, False, None, 25),
    (5, 5, True, 2, 9),                # 1 + 2 + 2 + 2 + 2
    (200, 200, True, None, 20100),     # T not a multiple of 128
    (200, 200, True, 64, 2080 + 136 * 64),
    (130, 130, False, 3, None),
])
def test_flash_band_by_hand(T, S, causal, window, want):
    got = band_pairs(T, S, causal, window)
    assert got == loop_pairs(T, S, causal, window)
    if want is not None:
        assert got == want


def test_flash_work_counts_the_band_not_the_padded_grid():
    B, T, Hq, Hkv, d = 2, 2048, 32, 8, 128
    flops, bytes_ = flash_work(B, T, T, Hq, Hkv, d, True, None)
    assert flops == 4 * d * Hq * B * T * (T + 1) // 2
    assert bytes_ == 2 * (2 * B * T * Hq * d + 2 * B * T * Hkv * d)
    # the reference's Pallas grid visits all (T/128)^2 blocks: about twice
    grid = 4 * d * Hq * B * T * T
    assert grid / flops == pytest.approx(2.0, rel=1e-3)


def loop_ssd_flops(B, S, nh, hd, N, G, Q):
    """The products of the chunked algorithm, counted one loop at a time."""
    f = 0
    for _ in range(B):
        for _ in range(S // Q):
            for _ in range(G):                      # C Bᵀ once a group
                f += sum(2 * N for i in range(Q) for j in range(i + 1))
            for _ in range(nh):
                f += sum(2 * hd for i in range(Q) for j in range(i + 1))
                f += 2 * Q * hd * N                 # chunk state
                f += 2 * Q * N * hd                 # output from the state
                f += 2 * hd * N                     # carry
    return f


@pytest.mark.parametrize("B,S,nh,hd,N,G,Q", [
    (1, 4, 2, 2, 2, 1, 2), (2, 12, 4, 4, 2, 2, 4), (1, 64, 8, 4, 4, 1, 16)])
def test_ssd_by_loops(B, S, nh, hd, N, G, Q):
    flops, bytes_ = ssd_work(B, S, nh, hd, N, G, Q)
    assert flops == loop_ssd_flops(B, S, nh, hd, N, G, Q)
    assert bytes_ == (2 * B * S * nh * hd * 2 + B * S * nh * 4 + nh * 4
                      + 2 * B * S * G * N * 2 + B * nh * hd * N * 4)


def test_ssd_cb_once_a_group():
    """32 heads sharing one B/C group: C Bᵀ is counted once, not 32 times,
    and mamba2-370m's call moves about 153 MB."""
    one = ssd_work(8, 2048, 32, 64, 128, 1, 256)
    tri = 256 * 257 // 2
    per_head = ssd_work(8, 2048, 32, 64, 128, 1, 256)[0] \
        + 8 * 8 * 31 * tri * 2 * 128
    assert per_head - one[0] == 8 * 8 * 31 * tri * 2 * 128
    assert one[1] == pytest.approx(153e6, rel=0.01)
    with pytest.raises(ValueError):
        ssd_work(1, 100, 1, 16, 16, 1, 64)


@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-v0.1-52b-16l"])
def test_model_flops_match_the_port(name):
    import dataclasses
    from repro_torch.configs import get_config
    m = json.loads((ROOT / "cellbench" / "configs" / f"{name}.json")
                   .read_text())
    arch = {"mamba2-370m": "mamba2-370m",
            "jamba-v0.1-52b-16l": "jamba-v0.1-52b"}[name]
    cfg = dataclasses.replace(get_config(arch), n_layers=m["n_layers"])
    n = cfg.param_counts()["active"] - cfg.vocab_size * cfg.d_model
    assert flops_per_token(m, True) == 6.0 * n
    assert flops_per_token(m, False) == 2.0 * n
    if name == "mamba2-370m":
        assert n == pytest.approx(316.7e6, rel=1e-3)
    assert math.isfinite(n)
