"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their plain PyTorch
versions (``ref``) and the public dispatch (``ops``)."""
