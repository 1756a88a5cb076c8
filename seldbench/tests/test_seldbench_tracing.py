"""The traced window's reading, on made-up profiler rows: the union of kernel and
copy intervals, ranges' device-side shadows left out, idle gaps named by the host
op running at their middle, and the dropped-copy guard."""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from seldbench import tracing


class Row:
    def __init__(self, name, start, end, device=DeviceType.CUDA, kind="kernel", note=False):
        self._v = (name, start, end, device, kind, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


CPU = DeviceType.CPU


def reading():
    return tracing.Reading([
        Row(tracing.WINDOW_MARK, 0, 1000, CPU, "user_annotation", True),
        Row(tracing.WINDOW_MARK, 0, 5000, kind="gpu_user_annotation"),
        Row("layer", 0, 400, CPU, "user_annotation", True),
        Row("layer", 100, 300, kind="gpu_user_annotation"),
        Row("aten::copy_", 50, 350, CPU, "cpu_op"),
        Row("aten::item", 500, 900, CPU, "cpu_op"),
        Row("Memcpy HtoD (Pageable -> Device)", 100, 300, kind="gpu_memcpy"),
        Row("gemm", 200, 420),            # overlaps the copy: counted once
        Row("salsa_spatial_kernel", 450, 500),
        Row("late", 990, 1200),           # clipped to the window
    ])


def test_busy_time_is_the_union_of_rows_in_the_window():
    r = reading()
    assert r.window_s == pytest.approx(1e-6)
    assert r.busy_s == pytest.approx((320 + 50 + 10) / 1e9)
    assert r.idle_share() == pytest.approx(1 - 0.38)
    assert r.device_ms("salsa_spatial_kernel") == (pytest.approx(5e-5), 1)
    assert [n for n, _ in r.top_ops()] == ["gemm", "Memcpy HtoD (Pageable -> Device)",
                                           "salsa_spatial_kernel", "late"]


def test_idle_gaps_are_named_by_the_host_op_at_their_middle():
    gaps = tracing.Reading.idle_gaps(reading())
    assert gaps[0] == ["host: aten::item", pytest.approx(490e-9)]
    assert gaps[1] == ["host: aten::copy_", pytest.approx(100e-9)]


def test_a_copy_row_shorter_than_the_link_allows_is_not_measured():
    r = reading()
    assert r.copy_ms(expected_bytes=10, link_bytes_per_s=64e9) == pytest.approx(2e-4)
    assert r.copy_ms(expected_bytes=10**9, link_bytes_per_s=64e9) is None
