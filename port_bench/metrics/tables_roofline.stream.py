"""tables_roofline.stream: K2's (csrc/tables.cu, a count and a scan
kernel a call) percent of its bandwidth roofline over the profiled
steps."""

from port_bench.readers import roofline_share


def read(obs):
    return roofline_share(obs, "tables", "tables_count_kernel",
                          "tables_scan_kernel")
