"""The reduction of a trace: busy time as a union of device intervals, idle
gaps named by host spans, kernel groups from the data files."""
from __future__ import annotations

import pytest

from gpvbench.trace import (DeviceEvent, Profile, Spans, breakdown,
                            group_of, group_table, idle_gaps, union_seconds)


def test_union_counts_overlapping_streams_once():
    # two streams: a kernel on each overlapping, a copy beside a kernel,
    # one interval inside another, and a gap of 2 s
    events = [(0.0, 4.0), (1.0, 3.0), (2.0, 5.0), (7.0, 8.0), (7.5, 7.6)]
    summed = sum(b - a for a, b in events)
    assert summed == pytest.approx(10.1)       # self-times overcount
    assert union_seconds(events) == pytest.approx(6.0)
    prof = Profile([DeviceEvent(f"k{i}", a, b)
                    for i, (a, b) in enumerate(events)], 0.0, 10.0)
    assert prof.busy_s() == pytest.approx(6.0)
    assert 1 - prof.busy_s() / prof.window_s == pytest.approx(0.4)


def test_busy_clips_to_the_window():
    prof = Profile([DeviceEvent("a", -1.0, 1.0), DeviceEvent("b", 9.0, 12.0)],
                   0.0, 10.0)
    assert prof.busy_s() == pytest.approx(2.0)


def test_idle_gaps_and_their_names():
    assert idle_gaps([(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)], 0.0, 8.0) == [
        (0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    spans = Spans()
    spans.records += [("predict", 0.5, 7.0), ("decode", 2.5, 6.0)]
    events = [DeviceEvent("gemm", 1.0, 2.0), DeviceEvent("gemm", 1.5, 3.0),
              DeviceEvent("add", 5.0, 6.0)]
    out = breakdown(events, spans, 0.0, 8.0)
    assert out["device_ops"] == [["gemm", 2.5], ["add", 1.0]]
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"predict": 1.0, "decode": 2.0, "between calls": 2.0})


@pytest.mark.parametrize("name,group", [
    ("void gpv_attn::gpv_attn_tile_kernel<32, 64>", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "conv"),
    ("nvjet_tst_64x8_64x16_2x4_h_bz_bias_TNT", "gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<8, add>", "elementwise"),
])
def test_kernel_groups_from_data_files(name, group):
    assert group_of(name, group_table()) == group


def test_launch_gaps_hold_the_trace_to_the_counters():
    from gpvbench.trace import launch_gaps
    events = [DeviceEvent("void gpv_attn_tile_kernel<64, 4>", 0.0, 1.0),
              DeviceEvent("void gpv_attn_tile_kernel<64, 4>", 1.0, 2.0),
              DeviceEvent("void gpv_attn_decode_kernel<8>", 2.0, 3.0),
              DeviceEvent("void gpv_attn_tile_bi_kernel<4>", 3.0, 4.0)]
    counted = {"fused_attention.tile": 2, "fused_attention.decode": 1,
               "fused_biattention.tile": 1}
    assert launch_gaps(events, counted, "attention") == []
    # a record lost: read as a gap, never filled in from the others' mean
    assert launch_gaps(events[1:], counted, "attention") == [
        "fused_attention.tile: 1 traced, 2 launched"]
    # K2 under a name no data file holds: its variant reads short
    renamed = events[:3] + [DeviceEvent("void other_bi_kernel", 3.0, 4.0)]
    assert launch_gaps(renamed, counted, "attention") == [
        "fused_biattention.tile: 0 traced, 1 launched"]
    # a counter no data file names
    assert launch_gaps(events, dict(counted, **{"fused_attention.new": 3}),
                       "attention") == [
        "3 launches of fused_attention.new, which no "
        "kernels/attention-*.json names"]
