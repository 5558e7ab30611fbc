"""splice_extract_ms.map: mean host ms a build in splice's snippet
extractions, the first of every fragment and that of each merged
snippet (the program's ``splice.extract`` spans; traced runs)."""

from port_bench.spans import span_ms


def read(obs):
    return span_ms(obs, "splice.extract")
