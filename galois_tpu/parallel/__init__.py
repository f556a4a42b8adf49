"""Multi-device kernels: shard_map + collective implementations.

Public surface:

- ``sharded_fft(x, field, mesh, axis)`` — 4-step NTT with the stage
  exchange as ``all_to_all`` over the mesh axis, for 1-D inputs whose
  length admits a D x D split; falls back to a replicated local plan
  otherwise.
- ``sharded_batched_fft`` — batch axis sharded over devices, transform axis
  local (embarrassingly parallel; the common FEC/polynomial-batch shape).
- ``ShardedFFTPlan`` — the cached plan object behind both.
- ``sharded_decode(code, received, mesh, axis)`` — batched BCH/RS decode
  with the codeword axis sharded over the mesh (embarrassingly parallel).

The single-chip analogue is ``ops/_ntt.py``; the reference's (host-only)
staged-loop kernel is src/galois/_domains/_function.py:170-384.
"""

from ._fec_sharded import sharded_decode
from ._ntt_sharded import ShardedFFTPlan, sharded_batched_fft, sharded_fft

__all__ = ["sharded_fft", "sharded_batched_fft", "ShardedFFTPlan", "sharded_decode"]
