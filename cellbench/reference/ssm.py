"""The ``ssm`` family (Mamba-2, arXiv:2405.21060): every layer a Mamba-2
mixer and no FFN."""
from typing import Dict, List, Optional, Tuple


def kinds(m: Dict) -> List[Tuple[str, Optional[str], bool]]:
    ff = "ffn" if m.get("d_ff", 0) > 0 else None
    return [("ssm", ff, True)] * m["n_layers"]
