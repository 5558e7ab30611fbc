"""blit_roofline.stream: K3's (csrc/blit.cu) percent of its bandwidth
roofline over the profiled steps."""

from port_bench.readers import roofline_share


def read(obs):
    return roofline_share(obs, "blit", "blit_kernel")
