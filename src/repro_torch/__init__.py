"""PyTorch/CUDA port of the MNN-LLM serving engine (``repro`` is the JAX
reference).  Same subpackage layout as ``repro``; every hot op of the
serving main path runs in a hand-written Hopper kernel (``csrc/``), with a
plain PyTorch version beside it for the CPU."""
