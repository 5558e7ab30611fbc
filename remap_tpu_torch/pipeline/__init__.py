"""Pipeline stages on the device: the collect tail (blit pass) and the
foreground filter."""
