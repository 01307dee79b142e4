"""PyTorch/CUDA port of the ReviveMoE serving system.

The package mirrors ``repro``'s module layout (``configs``, ``core``,
``models``, ``kernels``, ``serving``, ``training``) but imports nothing of
it: it holds its own copy of every host module it needs.  Plain tensor
code is PyTorch; the kernels of the serving path are hand-written CUDA
for Hopper (``kernels/csrc``), each with a plain PyTorch version beside
it that runs when the tensors lie on the CPU.
"""
