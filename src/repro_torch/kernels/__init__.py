"""Hand-written Hopper kernels and their plain PyTorch versions (port of
``repro.kernels``).

Each kernel module holds, side by side: the plain PyTorch version of the
function (what a CPU tensor gets, and what tests and ``chip_smoke.py``
hold the kernel against), the wrapper that launches the CUDA kernel from
``repro_torch/csrc``, and that kernel's launch counter.  ``ops`` is the
public layer: CPU tensor -> plain version, CUDA tensor -> kernel, anything
else raises.  Nothing here is built or imported from CUDA at import time.
"""


class LaunchCounter:
    """Number of kernel launches made by one wrapper (incremented where
    the kernel is launched, and nowhere else)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, count={self.count})"
