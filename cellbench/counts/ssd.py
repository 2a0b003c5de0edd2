"""Work of one Mamba-2 SSD chunk-scan call (the state starting at zero):
the products the chunked algorithm needs and its inputs and outputs moved
once each."""
from __future__ import annotations

from typing import Tuple


def ssd_work(B: int, S: int, nh: int, hd: int, N: int, G: int, chunk: int,
             elt: int = 2, f32: int = 4) -> Tuple[int, int]:
    """(FLOPs, bytes) of x [B, S, nh, hd], dt [B, S, nh], A [nh], B and C
    [B, S, G, N] -> y [B, S, nh, hd] and the final state [B, nh, hd, N].

    A chunk of Q positions needs: C Bᵀ once for each group of heads that
    share B and C, over its causal triangle (Q(Q+1)/2 pairs, 2N each); the
    masked product with x a head (the triangle, 2·hd each); each head's
    chunk state Σ_j x_j ⊗ B_j (2·Q·hd·N); the output from the state
    entering the chunk, C_i · h (2·Q·N·hd); and the state carried on, h ←
    decay·h + state (2·hd·N). x, B, C and y move in ``elt`` bytes (bf16),
    dt, A and the state in float32."""
    if S % chunk:
        raise ValueError(f"seq {S} is not a multiple of chunk {chunk}")
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    per_chunk = (G * tri * 2 * N + nh * tri * 2 * hd
                 + nh * 2 * chunk * hd * N * 2 + nh * 2 * hd * N)
    flops = B * nc * per_chunk
    bytes_ = (2 * B * S * nh * hd * elt + B * S * nh * f32 + nh * f32
              + 2 * B * S * G * N * elt + B * nh * hd * N * f32)
    return flops, bytes_
