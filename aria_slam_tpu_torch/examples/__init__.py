"""Examples wiring the port's parts into user loops (counterpart of the
repository's examples/ directory)."""
