"""Device ops of the port: extraction, tables, matching, component
labels, foreground masks, canvases and the kernel wrappers under
``kernels``."""
