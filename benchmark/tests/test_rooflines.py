"""The yardstick's counts on known shapes, and the timeline reading on a
made-up trace."""

import pytest

from benchmark import rooflines as r
from benchmark.trace import Timeline, short_name

NET = {"feature_dims": 8, "hidden": 64, "hidden_layers": 3, "pointnet_in": 6,
       "pe_fns": 1, "bias_std": 0.1}


def test_layer_dims_are_the_reference_widths():
    d = r.layer_dims(NET)
    assert d["encoder"] == [6, 64, 64, 64, 8]
    assert d["decoder"] == [17, 64, 64, 64, 1]


def test_operation_counts():
    d = r.layer_dims(NET)
    assert r.macs(d["encoder"]) == 6 * 64 + 2 * 64 * 64 + 64 * 8 == 9088
    assert r.macs(d["decoder"]) == 17 * 64 + 2 * 64 * 64 + 64 == 9344
    assert r.encoder_flops(1, d["encoder"]) == 8 * 2 * 9088
    assert r.decoder_flops(10, d["decoder"]) == 10 * 8 * 2 * 9344
    assert r.decoder_flops(10, d["decoder"], True) == 2 * 10 * 8 * 2 * 9344


def test_byte_counts():
    # 10 rows, 6 valid, 2 keys, 1 int + 3 float channels, 2 segments
    assert r.seg_stage_bytes(10, 6, 2, 1, 3, 2) == 4 * (20 + 24 + 12 + 1)
    b = r.fuse_seg_reduce_bytes(100, 80, 30, 50, 16, 40, 8)
    s1 = 4 * (100 * 2 + 80 * 65 + 16 * 67 + 1)
    s2 = 4 * (128 * 1 + 128 * 9 + 40 * 10 + 1)
    assert b == s1 + s2
    dd = r.layer_dims(NET)["decoder"]
    assert r.decode_bytes(2, 8, dd) == 4 * (2 * (24 + 64 + 8 + 1) + 9344 +
                                            3 * 64 + 1)


def test_bound_takes_the_slower_unit():
    assert r.bound_s(495e12, 0) == pytest.approx(1.0)
    assert r.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert r.bound_s(495e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_timeline_union_gaps_and_names():
    host = [("bench.window", 0.0, 100.0), ("bench.fuse", 0.0, 60.0),
            ("aten::nonzero", 50.0, 65.0), ("bench.mesh", 60.0, 100.0)]
    dev = [("void tile_sums_kernel<true>(int const*)", 10.0, 30.0),
           ("Memcpy HtoD", 20.0, 35.0), ("bench.fuse", 0.0, 60.0),
           ("fused_corner_decode_kernel<8>(float const*)", 80.0, 90.0)]
    t = Timeline(host, dev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)
    assert t.device_time(("tile_sums_kernel",)) == (pytest.approx(20e-6), 1)
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["fuse/aten::nonzero", pytest.approx(45e-6)]
    assert [g[0] for g in b["idle_gaps"]][1:] == ["fuse/python", "mesh/python"]
    assert b["device_ops"][0][0] == "tile_sums_kernel<true>"
    assert short_name("void a<b<c>>(x)") == "a<b<c>>"
