"""PyTorch + CUDA port of the in-hindsight quantized training system.

Mirrors the JAX package ``repro`` subpackage for subpackage (``core``,
``kernels``, ``models``, ``configs``, ``data``, ``launch``,
``telemetry``); each module's docstring names the reference module it
mirrors.  The port imports ``torch`` only — never ``jax`` and nothing of
``repro`` — and runs on a CUDA card unless the caller asks for the CPU.

The hot kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound with ``ctypes``; each has a plain
PyTorch version beside it (``repro_torch.kernels``) that the CPU tests
hold against the JAX reference.
"""
