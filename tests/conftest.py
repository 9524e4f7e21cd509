"""Test configuration: force CPU with 8 virtual devices (multi-device
sharding tests run on a virtual mesh; GPU runs happen via chip_smoke.py,
bench.py and the CLI)."""

import os

# Force the CPU backend through the env and, in case jax was imported
# before this file, through the config API as well.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_genome(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def sample_reads(rng, genome, num, length, max_err=0, edits=False):
    """Sample reads from genome with up to max_err errors. Returns codes."""
    from columba_jax.core import alphabet

    n = len(genome)
    reads = []
    for _ in range(num):
        pos = int(rng.integers(0, n - length - max_err - 1))
        seq = genome[pos:pos + length + max_err].copy()
        nerr = int(rng.integers(0, max_err + 1))
        for _ in range(nerr):
            i = int(rng.integers(0, length))
            if edits and rng.random() < 0.3:
                if rng.random() < 0.5:
                    seq = np.delete(seq, i)
                else:
                    seq = np.insert(seq, i, rng.integers(0, 4))
            else:
                seq[i] = (seq[i] + 1 + rng.integers(0, 3)) % 4
        seq = seq[:length]
        if rng.random() < 0.5:
            seq = alphabet.revcomp(seq)
        reads.append(seq)
    return np.stack(reads)


@pytest.fixture(scope="session")
def small_index():
    """A small deterministic index shared across tests."""
    from columba_jax.index.build import build_index_from_codes

    g = make_genome(np.random.default_rng(7), 20000)
    return g, build_index_from_codes(g)
