"""PyTorch/CUDA port of the ESAM serving path, for NVIDIA Hopper (sm_90a).

A second package beside the JAX reference ``repro``: the same module layout
(``core/packing.py``, ``core/esam/{network,plan,cost_model}.py``,
``kernels/cim_popcount``, ``serve/engine.py``, ``launch/serve.py``) in
PyTorch idiom.  It imports neither ``jax`` nor ``repro``.

Device rules:

* every entry point takes ``device=`` and defaults to ``"cuda"``; without a
  GPU it raises unless the caller passes ``device="cpu"``;
* the tensor's device picks the datapath: a CPU tensor runs the plain
  PyTorch version of a kernel, a CUDA tensor runs the hand-written CUDA
  kernel (built with ``nvcc`` at first use) or the call raises.
"""
