"""collect_match_ms.map: mean device ms a build in collect's batch match
(the keypoint match: kpm.match_tables' sorts, join and votes; the
program's ``collect.match`` spans directly under ``collect.pass`` and
``collect.repair``, each timed between its CUDA events; traced runs).
An event pair's time includes the stream's gaps between them, so a
stretch that the host paces reads near its host time.  None where a
build has no such span, or one without events (the CPU)."""

from port_bench.layer_spans import device_ms


def read(obs):
    return device_ms(obs, "collect.match",
                     ("collect.pass", "collect.repair"))
