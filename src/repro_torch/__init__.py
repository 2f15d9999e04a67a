"""PyTorch/CUDA port of the ``repro`` package (batched speculative decoding
with the adaptive b -> s controller), for one NVIDIA H100.

The layout mirrors ``src/repro/``: ``configs``, ``kernels`` (hand-written
CUDA sources under ``kernels/csrc``), ``models``, ``core``, ``serving`` and
``launch``.  Parameters and caches are nested dicts of tensors with the same
keys and the same stacked ``[n_layers, ...]`` layer layout as the JAX
package, so ``bridge.py`` carries weights across as a tree map.

Entry points run on the card by default and raise without CUDA unless the
caller passes ``device="cpu"``.  On a CPU tensor every kernel wrapper runs
its plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""
