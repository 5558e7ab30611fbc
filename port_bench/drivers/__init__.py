"""Entry drivers, one module a program entry; a workload names its
driver by module name."""
