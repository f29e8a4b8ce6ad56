"""The readers of the per-layer metrics that read the program's own spans
(`metamdbg_tpu_torch/utils/spans.py`), against values worked out by hand
on a synthetic window: a device timeline of known busy intervals, and
span records made here, in place of the program's.

Run from the repository's root: `python -m pytest -q portbench/tests`.
"""

import importlib
from types import SimpleNamespace

import pytest

from metamdbg_tpu_torch.utils import spans

READERS = ("unattributed_idle_share", "mapping_s_per_gbp",
           "fragment_index_s_per_gbp", "tiling_overlap_s_per_gbp",
           "tiling_pair_yield", "stage_rss_rise_gb")
T0 = 1_800_000_000_000_000_000     # the window's start, ns since the epoch
S = 1_000_000_000                  # a second, in ns
MAIN, WORKER = 1, 2                # thread idents


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}")


def rec(id_, name, start_s, end_s, parent=None, thread=MAIN, rss=None,
        **counts):
    return SimpleNamespace(id=id_, name=name, parent=parent, thread=thread,
                           start_ns=T0 + int(start_s * S),
                           end_ns=T0 + int(end_s * S), counts=counts,
                           rss_kb=rss, root=None)


def window(busy, seconds=10.0, bases=2e9):
    """A run of `seconds` over `bases` input bases whose device was busy
    over `busy`, (start, end) in seconds from the window's start."""
    timeline = SimpleNamespace(
        t0=T0, t1=T0 + int(seconds * S),
        busy_intervals=lambda: [[T0 + int(s * S), T0 + int(e * S)]
                                for s, e in busy])
    return SimpleNamespace(timeline=timeline, bases=bases, units=1)


# A unit from 0 to 8 s: its map 1-3 s, a tile 3-5 s with a walk 3.5-4.5 s
# inside, one polish pass 5-7 s with its index 5.5-6 s; a worker's span
# 7-8 s below the root; a root of an earlier session (before the window)
# and a span of another thread with no unit root, both to be left out.
RECORDS = [
    rec(1, "tobasespace", 0, 8, rss=(1_048_576, 2 * 1_048_576)),
    rec(2, "tobasespace.map", 1, 3, parent=1, rss=(1_100_000, 1_200_000),
        reads=700, groups=700, anchors=9000),
    rec(3, "tobasespace.tile", 3, 5, parent=1, rss=(1_200_000, 1_500_000)),
    rec(4, "tiling", 3, 5, parent=3, rss=(1_200_000, 1_572_864)),
    rec(5, "tiling.walk", 3.5, 4.5, parent=4, pair_calls=30,
        pair_cache_hits=10, pair_s=0.25, erroneous_s=0.5,
        successors_accepted=5),
    rec(6, "polish", 5, 7, parent=1, rss=(1_500_000, 1_900_000)),
    rec(7, "polish.index", 5.5, 6, parent=6, fragments=100),
    rec(8, "t.worker", 7, 8, parent=1, thread=WORKER),
    rec(9, "tobasespace", -5, -1, rss=(1, 3_000_000)),
    rec(10, "other", 0, 10, thread=WORKER),
]


@pytest.fixture
def recorded(monkeypatch):
    def use(records):
        monkeypatch.setattr(spans, "records", lambda: list(records))
    return use


def test_unattributed_idle_share(recorded):
    recorded(RECORDS)
    # idle: 0-2 s and 4-10 s (8 s); the unit's thread has a span below
    # its root open 1-7 s, so of the idle time 1-2 and 4-7 s are
    # attributed (4 s) and 0-1 and 7-10 s are not (4 s): 50%
    run = window(busy=[(2, 4)])
    assert reader("unattributed_idle_share").read(run) == \
        pytest.approx(50.0)


def test_a_gap_half_covered_by_a_phase_span_reads_half(recorded):
    recorded([rec(1, "tobasespace", 0, 10, rss=(1, 1)),
              rec(2, "tobasespace.map", 5, 10, parent=1)])
    assert reader("unattributed_idle_share").read(window(busy=[])) == \
        pytest.approx(50.0)


def test_seconds_per_gbp(recorded):
    recorded(RECORDS)
    run = window(busy=[])      # 2 Gbp
    assert reader("mapping_s_per_gbp").read(run) == pytest.approx(1.0)
    assert reader("fragment_index_s_per_gbp").read(run) == \
        pytest.approx(0.25)
    assert reader("tiling_overlap_s_per_gbp").read(run) == \
        pytest.approx(0.375)


def test_tiling_pair_yield(recorded):
    recorded(RECORDS + [rec(11, "tiling.walk", 4.6, 4.8, parent=4,
                            pair_calls=10, successors_accepted=5)])
    # (5 + 5) accepted of (30 - 10) + 10 computed
    assert reader("tiling_pair_yield").read(window(busy=[])) == \
        pytest.approx(100.0 * 10 / 30)


def test_stage_rss_rise_gb(recorded):
    recorded(RECORDS)
    # highest close below a unit root, 2 GiB (the root's own), less the
    # lowest root open, 1 GiB: the earlier session's root is outside the
    # window
    assert reader("stage_rss_rise_gb").read(window(busy=[])) == \
        pytest.approx(1.0)
    recorded([r for r in RECORDS if r.id != 1] +
             [rec(1, "tobasespace", 0, 8, rss=(1_048_576, 1_048_576))])
    assert reader("stage_rss_rise_gb").read(window(busy=[])) == \
        pytest.approx(1_900_000 / 1_048_576 - 1.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_span_of_its_own(recorded, name):
    recorded([rec(10, "other", 0, 10, thread=WORKER)])
    assert reader(name).read(window(busy=[(2, 4)])) is None
    recorded([])
    assert reader(name).read(window(busy=[])) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    import sys
    monkeypatch.setitem(sys.modules, "metamdbg_tpu_torch.utils.spans", None)
    assert reader(name).read(window(busy=[])) is None
