"""collect_dispatch_ms.map: mean host ms a build in collect's batch
steps: each batch's upload, features, match and scalars (the program's
``collect.upload``, ``collect.features``, ``collect.match`` and
``collect.scalars`` spans directly under ``collect.pass`` and
``collect.repair``; traced runs).  Outside it stay the waits on the
reader and on the card, and the store.  None where a build records no
such span."""

from port_bench.layer_spans import host_ms

PHASES = ("collect.upload", "collect.features", "collect.match",
          "collect.scalars")


def read(obs):
    return host_ms(obs, PHASES, ("collect.pass", "collect.repair"))
