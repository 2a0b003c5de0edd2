"""Frozen work counts: the operations and bytes that a kernel's inputs
need, and the model FLOPs of a step, worked out from shapes alone.

They are the benchmark's yardstick and do not come from the program's own
cost rules (``flash_cost``, ``ssd_cost``, ``runtime/cost_analysis.py``),
which count the reference's padded Pallas grid: every 128-block of a
causal attention, the blocks above the diagonal included, and C Bᵀ once a
head where the algorithm needs it once a group of heads that share B and
C. A faster kernel that does the same work reads the same count.
"""
