"""Pipeline stages on the device: the window scan, collect, splice, the
foreground filter and the artifact clean, and the builder that runs them."""
