"""The ``hybrid`` family (Jamba, arXiv:2403.19887): one attention layer
in every ``attn_period`` layers, at ``attn_offset``, Mamba-2 mixers in the
others; the MoE in every ``moe.every_k_layers``-th layer (from layer 0)
and the dense FFN in the rest."""
from typing import Dict, List, Optional, Tuple


def kinds(m: Dict) -> List[Tuple[str, Optional[str], bool]]:
    out = []
    for i in range(m["n_layers"]):
        mixer = ("attn" if i % m["attn_period"] == m.get("attn_offset", 0)
                 else "ssm")
        moe = m.get("moe")
        ff = ("moe" if moe and i % moe.get("every_k_layers", 1) == 0
              else "ffn" if m.get("d_ff", 0) > 0 else None)
        gp = m.get("global_period", 0)
        out.append((mixer, ff, gp <= 0 or i % gp == gp - 1))
    return out
