"""The trace reduction of benchmarks/trace_tall_batch.py (busy time is
the union of device intervals, so overlapping kernels count once)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

from trace_tall_batch import interval_union_ns  # noqa: E402


def test_interval_union_merges_overlaps_and_keeps_gaps():
    assert interval_union_ns([]) == 0.0
    assert interval_union_ns([(0, 10)]) == 10
    # (0,10) and (5,12) overlap -> 12; (20,25) after a gap -> +5;
    # (21,22) nested -> +0; unsorted input.
    assert interval_union_ns([(20, 25), (5, 12), (0, 10), (21, 22)]) == 17
