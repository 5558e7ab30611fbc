"""splice_need_ms.map: mean host ms a build in splice's multiplicity
estimate, the snippets' code counts and ``_needed_multiplicity`` (the
program's ``splice.need`` spans; traced runs)."""

from port_bench.recorded import span_ms


def read(obs):
    return span_ms(obs, "splice.need")
