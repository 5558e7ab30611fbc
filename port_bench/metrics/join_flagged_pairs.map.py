"""join_flagged_pairs.map: mean pairs a build that collect's first pass
leaves flagged by the join's multiplicity (the program's counter
``collect.join_flagged`` in the ``collect.pass`` span with ``rung`` 0;
traced runs).  None where no build of the window counts
``collect.table_flagged``, as a version without the counters."""

from port_bench import spans


def _first_pass(record) -> int:
    return sum(s.counts.get("collect.join_flagged", 0) for s in record.spans
               if s.name == "collect.pass" and s.attrs.get("rung") == 0)


def read(obs):
    records = spans.window_builds(obs)
    if not records or not any("collect.table_flagged" in r.counters
                              for r in records):
        return None
    return spans.mean_per_build(obs, _first_pass)
