"""PyTorch/CUDA port of the FFCL compile-and-serve system.

A second package beside ``repro``: the numpy compiler front end is carried
over as verbatim copies under ``repro_torch.core``, and the serving path
(bit packing, the levelized gate-program executors, ``LogicEngine``) runs
in PyTorch with the program executors as hand-written CUDA kernels for
Hopper (``csrc/logic_dsp.cu``).  The NullaNet flow (``repro_torch.flow``:
train a binarized MLP, convert its hidden layers to logic, run them through
every backend) trains in PyTorch, and the paper's XNOR-popcount baseline
(``kernels/xnor_gemm``) is a CUDA kernel too (``csrc/xnor_gemm.cu``).
Nothing here imports ``jax`` or ``repro``.
"""
