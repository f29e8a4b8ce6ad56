"""The readers of the per-layer metrics of `ont_d6331.tobasespace` and
`hifi_msa1003.readselection`, against values worked out by hand on a
synthetic window, and K1's bound (`portbench/metrics/k1_roofline.py`)
against `chip_smoke.py:k1_bound`, of which it is a copy.

Run from the repository's root: `python -m pytest -q portbench/tests`.
"""

import importlib
import os
import sys
from types import SimpleNamespace

import pytest

from metamdbg_tpu_torch.kernels import sketch as ksketch
from metamdbg_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

READERS = ("polish_refine_s_per_gbp", "refine_bases_share",
           "readselection_sketch_s_per_gbp", "k1_roofline")
T0 = 1_800_000_000_000_000_000     # the window's start, ns since the epoch
S = 1_000_000_000                  # a second, in ns
K1 = "void (anonymous namespace)::sketch_tiles_kernel<15>(...)"


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}")


def rec(id_, name, start_s, end_s, parent=None, **counts):
    return SimpleNamespace(id=id_, name=name, parent=parent, thread=1,
                           start_ns=T0 + int(start_s * S),
                           end_ns=T0 + int(end_s * S), counts=counts,
                           rss_kb=None, root=None)


def window(device=(), seconds=10.0, bases=2e9):
    """A run of `seconds` over `bases` input bases whose device ran
    `device`: (start, end, kernel name), in seconds from the start."""
    timeline = SimpleNamespace(
        t0=T0, t1=T0 + int(seconds * S),
        device=[(T0 + int(s * S), T0 + int(e * S), n) for s, e, n in device])
    return SimpleNamespace(timeline=timeline, bases=bases, units=1)


@pytest.fixture
def recorded(monkeypatch):
    def use(records):
        monkeypatch.setattr(spans, "records", lambda: list(records))
    return use


# -- K1's bound ---------------------------------------------------------------

@pytest.mark.parametrize("n,L,l,density", [
    (512, 16384, 15, 0.005),     # read selection's full launch
    (37, 16384, 15, 0.025),      # a blacklist pass's last launch
    (1, 4096, 31, 0.1),          # a short row, a long minimizer
])
def test_k1_bound_is_chip_smokes(n, L, l, density):
    cap = ksketch.compact_cap(L - l + 1, density)
    seconds, by = reader("k1_roofline").k1_bound(n, L, l, cap)
    ms, by_smoke = chip_smoke.k1_bound(n, L, l, cap)
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-12)
    assert by == by_smoke


def test_k1_roofline(recorded):
    k1 = reader("k1_roofline")
    cap = ksketch.compact_cap(16384 - 15 + 1, 0.005)
    # two launches of 512 rows and one of 100 on one span, one launch of
    # 8 rows at another density on another span
    sketch = dict(k1_launches=3, k1_rows=1124, k1_row_len=3 * 16384,
                  k1_windows=1124 * (16384 - 14), k1_cap=3 * cap)
    cap2 = ksketch.compact_cap(16384 - 14, 0.025)
    repeats = dict(k1_launches=1, k1_rows=8, k1_row_len=16384,
                   k1_windows=8 * (16384 - 14), k1_cap=cap2)
    recorded([rec(1, "readselection", 0, 9),
              rec(2, "readselection.sketch", 1, 2, parent=1, **sketch),
              rec(3, "readselection.repeats", 0, 1, parent=1, **repeats),
              rec(4, "readselection.sketch", -3, -2, **sketch)])
    want = sum(k1.k1_bound(n, 16384, 15, c)[0]
               for n, c in ((512, cap), (512, cap), (100, cap), (8, cap2)))
    # 2 ms of K1 on the device, and a copy that is no K1 time
    run = window(device=[(1.0, 1.0015, K1), (1.5, 1.5005, K1),
                         (1.6, 1.7, "Memcpy DtoH")])
    assert k1.read(run) == pytest.approx(100.0 * want / 0.002)


# -- the refinement and read selection's phases -------------------------------

def test_the_refinement_readers(recorded):
    recorded([rec(1, "tobasespace", 0, 8, polished_bases=4_000_000),
              rec(2, "polish", 1, 3, parent=1, **{"pass": 0}),
              rec(3, "polish", 3, 5, parent=1, **{"pass": 1}),
              rec(4, "polish", 5, 6.5, parent=1, restricted=1, contigs=2,
                  regions=2, bases=3_000_000, whole=1),
              rec(5, "tobasespace", 8, 10, polished_bases=1_000_000),
              rec(6, "polish", 9, 9.5, parent=5, restricted=1, contigs=1,
                  regions=1, bases=1_000_000, whole=1),
              rec(7, "polish", -3, -2, restricted=1, bases=7)])
    run = window()         # 2 Gbp
    assert reader("polish_refine_s_per_gbp").read(run) == \
        pytest.approx(1.0)
    assert reader("refine_bases_share").read(run) == pytest.approx(80.0)


def test_the_read_selection_readers(recorded):
    recorded([rec(1, "readselection", 0, 8),
              rec(2, "readselection.repeats", 0, 0.5, parent=1),
              rec(3, "readselection.sketch", 1, 4, parent=1),
              rec(4, "readselection.sketch", 5, 6, parent=1)])
    run = window()
    # the blacklist pass is no chunk's sketch
    assert reader("readselection_sketch_s_per_gbp").read(run) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_span_of_its_own(recorded, name):
    # the parent's spans: a refinement without counts of bases, a unit
    # root without polished bases, no read selection
    recorded([rec(1, "tobasespace", 0, 8),
              rec(2, "polish", 1, 3, parent=1, **{"pass": 0})])
    assert reader(name).read(window(device=[(1, 2, K1)])) is None
    recorded([])
    assert reader(name).read(window()) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "metamdbg_tpu_torch.utils.spans", None)
    assert reader(name).read(window(device=[(1, 2, K1)])) is None
