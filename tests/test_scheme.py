"""Search-scheme model: parsing, validation, coverage (validity checker)."""

import numpy as np
import pytest

from columba_jax.search import schedule
from columba_jax.search.scheme import (
    BACKWARD,
    FORWARD,
    Search,
    get_scheme,
    parse_search_line,
    pigeonhole_scheme,
)


def test_parse_and_str_roundtrip():
    s = parse_search_line("{1,0,2} {0,0,1} {0,1,2}")
    assert s.pi == (1, 0, 2)
    assert s.lower == (0, 0, 1)
    assert s.upper == (0, 1, 2)
    assert str(s) == "{1,0,2} {0,0,1} {0,1,2}"


def test_directions():
    s = parse_search_line("{1,0,2} {0,0,1} {0,1,2}")
    # phase 0 copies phase 1 (backward), then forward
    assert s.directions == (BACKWARD, BACKWARD, FORWARD)
    s2 = parse_search_line("{0,1,2} {0,0,0} {0,2,2}")
    assert s2.directions == (FORWARD, FORWARD, FORWARD)


def test_invalid_searches():
    with pytest.raises(ValueError):
        Search((0, 2, 1), (0, 0, 0), (0, 1, 1))  # not connected
    with pytest.raises(ValueError):
        Search((1, 1, 0), (0, 0, 0), (0, 1, 1))  # not a permutation
    with pytest.raises(ValueError):
        Search((0, 1), (0, 1), (1, 0))  # U decreasing
    with pytest.raises(ValueError):
        Search((0, 1), (1, 0), (1, 1))  # L decreasing


@pytest.mark.parametrize("name", ["kuch1", "kuch2", "kianfar", "01*0", "pigeon"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bundled_schemes_lossless(name, k):
    scheme = get_scheme(name, k)
    assert scheme.is_valid(), scheme.uncovered_distributions()[:5]
    assert all(s.max_errors == k for s in [scheme.searches[scheme.critical_search_index]])


def test_invalid_scheme_detected():
    from columba_jax.search.scheme import SearchScheme

    # pigeonhole missing one search cannot cover all distributions
    full = pigeonhole_scheme(2)
    broken = SearchScheme(full.searches[:-1], k=2)
    assert not broken.is_valid()


def test_schedule_compiles_for_all_bundled():
    for name in ["kuch1", "kuch2", "kianfar", "01*0", "pigeon"]:
        for k in [1, 2, 3, 4]:
            sch = get_scheme(name, k)
            for metric in ("edit", "hamming"):
                sd = schedule.compile_schedule(sch, 100, metric=metric)
                kb = k if metric == "edit" else 0
                assert sd.bw == 2 * kb + 1
                # every search's band steps cover the full pattern + overshoot
                for i, s in enumerate(sch.searches):
                    active_steps = int(sd.active[i].sum())
                    exact_steps = int((sd.ex_pos[i] >= 0).sum())
                    side_ov = (
                        (kb if sd.t_back[i] != sd.pivot[i] else 0)
                        + (kb if (active_steps + exact_steps)
                           - (100 + (kb if sd.t_back[i] != sd.pivot[i] else 0)) > 0 else 0)
                    )
                    assert exact_steps + active_steps >= 100
                    assert exact_steps + active_steps <= 100 + 2 * kb


def test_schedule_exact_prefix_positions():
    sch = get_scheme("pigeon", 1)  # 2 parts, m=10 -> parts [0,5) [5,10)
    sd = schedule.compile_schedule(sch, 10, metric="hamming")
    # search 0: pi=(0,1) fwd: exact part 0 = positions 0..4 in order
    np.testing.assert_array_equal(sd.ex_pos[0][:5], np.arange(5))
    assert sd.pivot[0] == 0
    # search 1: pi=(1,0) backward: exact part 1 = positions 9..5
    np.testing.assert_array_equal(sd.ex_pos[1][:5], np.arange(9, 4, -1))
    assert sd.pivot[1] == 10


def test_short_parts_use_multiple_colmin_registers():
    sch = get_scheme("pigeon", 4)  # 5 parts
    sd = schedule.compile_schedule(sch, 40, metric="edit")  # parts of 8 = 2k
    assert sd.W > 1  # overlapping windows -> rotating registers
    with pytest.raises(ValueError):  # empty parts still raise
        schedule.compile_schedule(sch, 4, metric="edit")


def test_static_partitioning_files():
    sch = get_scheme("kuch1", 2)
    assert sch.static_fracs == (0.41, 0.7)
    assert sch.seed_fracs == (0.57,)
    assert sch.weights == (39, 10, 40)
    sd = schedule.compile_schedule(
        sch, 100, partition=schedule.static_partition(100, sch.static_fracs),
        metric="edit",
    )
    assert sd.m == 100


def test_static_partition_conformance(rng):
    import numpy as np

    from columba_jax.index.build import build_index_from_codes
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.search import pipeline
    from tests.conftest import make_genome, sample_reads

    g = make_genome(np.random.default_rng(9), 8000)
    index = FMIndex.from_arrays(build_index_from_codes(g))
    reads = sample_reads(rng, g, num=6, length=80, max_err=2, edits=True)
    key = lambda os: {(o.read_id, o.strand, o.end, o.distance) for o in os}
    a, _ = pipeline.match_all(index, reads, get_scheme("kuch1", 2),
                              metric="edit", redundancy_filter=False)
    b, _ = pipeline.match_all(index, reads, get_scheme("kuch1", 2),
                              metric="edit", redundancy_filter=False,
                              partitioning="static")
    assert key(a) == key(b)  # both lossless -> same occurrence set


def test_manbest_and_suffix_filter_bundled():
    """manbest (k=4 only, reference search_schemes/manbest) and the suffix
    filter family load from the registry and are usable; the adapted
    variants load as custom folders (reference ships them for the paper-2
    reproduction, search_schemes/*_adapted)."""
    import os

    from columba_jax.search.scheme import _SCHEME_DIR

    mb = get_scheme("manbest", 4)
    assert mb.k == 4 and len(mb.searches) == 5
    for k in (1, 2, 4, 8, 13):
        sf = get_scheme("suffix_filter", k)
        assert sf.k == k
        assert sf.is_valid(), sf.uncovered_distributions()[:3]
    for folder in ("kuch_k+1_adapted", "kuch_k+2_adapted",
                   "pigeon_adapted", "01star0_adapted"):
        sc = get_scheme(os.path.join(_SCHEME_DIR, folder), 4)
        assert sc.k == 4 and sc.is_valid()


def test_manbest_schedule_compiles():
    from columba_jax.search import schedule

    sched = schedule.compile_schedule(get_scheme("manbest", 4), 100,
                                      metric="edit")
    assert sched.num_searches == 5
