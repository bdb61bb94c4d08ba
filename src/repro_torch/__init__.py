"""PyTorch/CUDA port of the coded matmul (C = A^T B) for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (the reference, which this
package never imports): ``core`` (plans, schemes, bounds, decoding),
``kernels`` (hand-written CUDA kernels, their plain PyTorch versions and
wrappers) and ``runtime`` (the ``CodedMatmul`` facade and its executors).
"""
