"""columba_jax: a lossless approximate pattern-matching framework in JAX.

Re-implements the capabilities of biointec/columba (lossless read mapping via
search schemes on a bidirectional FM-index) with an accelerator-first design:

- The FM-index (packed BWT, occ checkpoints, sparse SA samples, k-mer table)
  lives in HBM, replicated per chip.
- Search-scheme execution is a lockstep, branch-free *frontier* computation:
  fixed-capacity batches of SA-interval nodes are extended one text character
  per step with 4-way fan-out, banded edit-distance state is carried as small
  per-node vectors, and pruning/compaction are masked vector ops.
- Candidate hits are located via batched LF-walks and verified in-text with a
  banded semi-global DP kernel.
- Read batches shard data-parallel over a `jax.sharding.Mesh`; the index is
  replicated; counters reduce with psum.

Reference behavior map: see SURVEY.md (layer map of /root/reference).
"""

__version__ = "0.1.0"

from columba_jax.index.build import build_index, load_index  # noqa: F401
from columba_jax.index.fmindex import FMIndex  # noqa: F401
