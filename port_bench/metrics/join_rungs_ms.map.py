"""join_rungs_ms.map: mean device ms a build in collect's rungs that the
join's multiplicity tripped (the program's ``collect.pass`` and
``collect.repair`` spans whose ``limit`` is ``"multiplicity"``, each
timed between its CUDA events; traced runs).  A build with no such rung
reads 0.  None where no span of the window records a ``limit`` (a
version without it), or where such a rung has no events (the CPU)."""

from port_bench import spans

RUNGS = ("collect.pass", "collect.repair")


def read(obs):
    records = spans.window_builds(obs)
    if not records or not any("limit" in s.attrs for r in records
                              for s in r.spans if s.name in RUNGS):
        return None
    missing = []

    def total(record):
        ms = [s.device_ms() for s in record.spans if s.name in RUNGS
              and s.attrs.get("limit") == "multiplicity"]
        if None in ms:
            missing.append(record)
            return 0.0
        return sum(ms)

    mean = spans.mean_per_build(obs, total)
    return None if missing else mean
