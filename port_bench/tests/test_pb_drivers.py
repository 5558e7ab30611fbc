"""Each entry driver at a small size on the CPU against the reference."""

import pytest

from port_bench.tests import small


@pytest.mark.parametrize("name", ["c64_map_break", "c64_map_clean",
                                  "nes_stream_ingest"])
def test_driver_matches_reference(name, tmp_path):
    result = small.run(name, tmp_path)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"]
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", ["c64_map_break", "nes_stream_ingest"])
def test_traced_run_reads_its_metrics(name, tmp_path):
    result = small.run(name, tmp_path, trace=True)
    assert result["correct"], result["checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only host-clock metrics are read
    assert all(not k.endswith(("_roofline.stream", "idle_share.map"))
               for k in result["metrics"])
    assert result["metrics"], result
