"""Kernels of the port: hand-written CUDA for Hopper with plain PyTorch
versions beside them.

``ops.spec_verify_attn`` is the verify / prefill attention (the port of the
TPU kernel ``spec_verify_attn_pallas``); its CUDA source is
``csrc/spec_verify_attn.cu``, built at first use by ``build.py``; ``ref.py``
holds the plain versions that the CPU runs and the tests compare against.
"""
