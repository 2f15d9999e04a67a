"""Host-side grid arithmetic for the ragged paged verify attention (the
host half of ``repro.kernels.tuning``).

* :func:`host_cu_blocks` builds the ``[B + 1]`` cumulative step counts from
  the host block tables that the engine's ``PagedKVTables`` already holds,
  so the ragged kernel (K3, ``csrc/paged_verify_attn.cu``) gets its per-slot
  step counts without a device round trip.  Every slot keeps at least one
  (dead) step, so an empty slot still finalizes its output rows to zeros.
* :func:`grid_steps_ragged` / :func:`grid_steps_dense` /
  :func:`dead_tile_fraction` are the step counts of the two launch shapes
  (K3 walks ``sum max(live, 1)`` blocks, K2 ``B * MAXB`` table entries).

The JAX module's ``RaggedConfig`` / ``lookup_config`` hold TPU launch knobs
(manual-DMA depth, VMEM budget) read from an autotune file; they have no
counterpart here.  The functions take numpy tables and build their arrays
with ``np.zeros`` / ``np.cumsum`` only.
"""
from __future__ import annotations

import numpy as np


def host_cu_blocks(tables: np.ndarray) -> np.ndarray:
    """Cumulative ragged step counts ``[B + 1]`` int32 from host block
    tables ``[B, MAXB]`` (physical ids, -1 unused): per-slot steps =
    ``max(live, 1)``."""
    steps = np.maximum((tables >= 0).sum(axis=1), 1)
    cu = np.zeros(tables.shape[0] + 1, np.int32)
    np.cumsum(steps, out=cu[1:])
    return cu


def grid_steps_ragged(tables: np.ndarray) -> int:
    """Total ragged steps for these tables: ``sum max(live, 1)``."""
    return int(host_cu_blocks(tables)[-1])


def grid_steps_dense(tables: np.ndarray) -> int:
    """Total dense steps: ``B * MAXB``, raggedness notwithstanding."""
    return int(tables.shape[0] * tables.shape[1])


def dead_tile_fraction(tables: np.ndarray) -> float:
    """Fraction of the dense grid that is dead table entries: the share of
    steps the ragged kernel does not take."""
    dense = grid_steps_dense(tables)
    return 1.0 - grid_steps_ragged(tables) / float(dense) if dense else 0.0
