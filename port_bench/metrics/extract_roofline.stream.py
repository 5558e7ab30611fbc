"""extract_roofline.stream: K1's (csrc/extract.cu) percent of its
bandwidth roofline over the profiled steps: the bytes of roofline.py
over its device time a step."""

from port_bench.readers import roofline_share


def read(obs):
    return roofline_share(obs, "extract", "extract_kernel")
