"""Device-side bidirectional FM-index.

The device-resident equivalent of the reference's ``FMIndex``
(reference: src/fmindex/fmindex.h:43-571): all arrays live in HBM as dense
jnp tensors, replicated per chip. Character extension, locate and text access
are *batched* ops over frontiers of SA-interval pairs (see columba_jax.ops).

Key layout decision: the forward-BWT and reverse-BWT words (and their occ
checkpoints) are **concatenated** into single arrays. A frontier mixes nodes
extending backward (querying the fwd BWT) and forward (querying the rev BWT);
with the concatenated layout the extension direction is just a block offset,
so one batched gather serves a mixed-direction frontier — no masked dual
computation, no host-side regrouping.

Range convention: a node's state is a length-4 int32 vector
``[f_lo, f_hi, r_lo, r_hi)`` — half-open SA interval in the forward index and
the synchronized interval in the reverse index (same width), mirroring the
reference's ``SARangePair`` (src/indexhelpers.h:1057+).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from columba_jax.index.build import IndexArrays

KMER_K = 10  # seed table k-mer size (reference default, src/definitions.h)


def _pad_reshape4(bits) -> np.ndarray:
    """Packed bit words -> (blocks, 4) uint32 rows (pad to a whole row)."""
    w = np.asarray(bits, dtype=np.uint32)
    pad = (-len(w)) % 4
    if pad:
        w = np.concatenate([w, np.zeros(pad, np.uint32)])
    return w.reshape(-1, 4)


@dataclass(frozen=True)
class FMIndex:
    """Replicated device arrays of one index. A pytree of jnp arrays."""

    occ_fused: jax.Array  # (2*blocks, 16) uint32: [4 ckpt | 8 BWT words |
                          # 4 pad] — fwd blocks then rev blocks. One 64B row
                          # gather serves a full rank query (interleaved-
                          # rank9 analogue of reference src/bitvec.h:234-478).
                          # Rows are padded 48->64B to keep each row aligned
                          # (whether that pays on the GPU: ROADMAP C1)
    counts: jax.Array     # (4,) uint32 first SA row per char (A,C,G,T)
    dollar: jax.Array     # (2,) uint32: '$' row in [fwd, rev] BWT
    text: jax.Array       # packed genome words as (rows, 128) uint32 —
                          # 2048 chars/row; ops/verify.py gathers whole
                          # rows (layout under review: ROADMAP C1)
    sa_samples: jax.Array  # uint32, SA values at sampled rows, SA-row order
    sa_bits: jax.Array     # packed uint32 marker bits over rows
    sa_bits_rank: jax.Array  # (blocks,) uint32
    n_arr: jax.Array      # (2,) uint32: [n (text length), n+1 (rows)]

    # -- static metadata (not traced) --
    n: int = 0
    blocks: int = 0       # occ blocks per direction
    sa_sparseness: int = 4

    @staticmethod
    def from_arrays(arrays: IndexArrays) -> "FMIndex":
        n = arrays.n
        blocks = arrays.occ.shape[0]
        assert arrays.rocc.shape[0] == blocks
        assert arrays.bwt.shape[0] == blocks * 8, (arrays.bwt.shape, blocks)
        tw = np.asarray(arrays.text, dtype=np.uint32)
        pad = (-len(tw)) % 128 + 128   # tail pad + one spare row (row+1
        text = np.concatenate(         # gathers clip, spare keeps them
            [tw, np.zeros(pad, np.uint32)]).reshape(-1, 128)  # in-bounds
        occ_cat = np.concatenate([arrays.occ, arrays.rocc])
        words_cat = np.concatenate([arrays.bwt, arrays.rbwt]).reshape(-1, 8)
        fused = np.zeros((2 * blocks, 16), dtype=np.uint32)
        fused[:, :4] = occ_cat.astype(np.uint32)
        fused[:, 4:12] = words_cat
        # positions/counts are uint32 on device (single-index genomes to
        # ~4.29 Gbp; round-1 indexes persisted int32 load via the cast)
        return FMIndex(
            occ_fused=jax.device_put(fused),
            counts=jnp.asarray(np.asarray(arrays.counts, dtype=np.uint32)),
            dollar=jnp.asarray(
                np.asarray([arrays.dollar_fwd, arrays.dollar_rev],
                           dtype=np.uint32)
            ),
            text=jax.device_put(text),
            sa_samples=jax.device_put(
                np.asarray(arrays.sa_samples, dtype=np.uint32)),
            # (blocks, 4) row layout, shaped on the host so the program
            # never reshapes the whole marker array (ROADMAP C1)
            sa_bits=jnp.asarray(_pad_reshape4(arrays.sa_bits)),
            sa_bits_rank=jnp.asarray(
                np.asarray(arrays.sa_bits_rank, dtype=np.uint32)),
            n_arr=jnp.asarray(np.asarray([n, n + 1], dtype=np.uint32)),
            n=n,
            blocks=blocks,
            sa_sparseness=arrays.meta["sa_sparseness"],
        )

    @property
    def num_rows(self) -> int:
        return self.n + 1

    def full_range(self, batch_shape=()) -> jax.Array:
        """The whole-index SARangePair [0, n+1, 0, n+1) broadcast to batch."""
        r = jnp.array([0, self.n + 1, 0, self.n + 1], dtype=jnp.uint32)
        return jnp.broadcast_to(r, (*batch_shape, 4))


jax.tree_util.register_dataclass(
    FMIndex,
    data_fields=[
        "occ_fused", "counts", "dollar", "text",
        "sa_samples", "sa_bits", "sa_bits_rank", "n_arr",
    ],
    meta_fields=["n", "blocks", "sa_sparseness"],
)
