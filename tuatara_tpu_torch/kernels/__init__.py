"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper (in `cc.py`, `stats.py`, `vit.py`, `decode.py`, `stage1.py`,
`hull.py`, `bias_act.py`, `stem.py`) takes a tensor on the card to its CUDA
kernel and a tensor on the CPU to the plain PyTorch version beside it.
`LAUNCHES[name]` counts the kernel launches only, so a run can show that
the main path went through the kernels. `int8.py` holds int8 serving's
convolution and linear layer, library GEMMs (`torch._int_mm`) rather than
hand-written kernels, counted as "int8_conv" once a convolution and
"int8_linear" once a product.
"""

from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
