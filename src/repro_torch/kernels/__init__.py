"""Kernels of the port: hand-written CUDA for Hopper with plain PyTorch
versions beside them.

``ops.spec_verify_attn`` is the verify / prefill attention on a contiguous
ring (K1, the port of the TPU kernel ``spec_verify_attn_pallas``; source
``csrc/spec_verify_attn.cu``).  ``paged.paged_verify_attn`` is the verify
attention against the paged KV pool: K2 (dense walk of the block table) and
K3 (ragged walk of the live blocks, fed by ``tuning.host_cu_blocks``), the
ports of ``paged_verify_attn_pallas`` and ``ragged_paged_verify_attn_pallas``
(source ``csrc/paged_verify_attn.cu``).  ``ops.flash_attn`` is the
position-masked flash attention of training and ``prefill_flash`` (K4, the
port of ``flash_attn_pallas``; source ``csrc/flash_attn.cu``) and
``ops.rmsnorm`` every norm of every path (K5, the port of
``rmsnorm_pallas``; source ``csrc/rmsnorm.cu``), each forward and backward.
``build.py`` builds the sources at first use; ``ref.py`` and ``paged.py``'s
gather path are the plain versions that the CPU runs and the tests compare
against.
"""
