"""The engines: serial (parity) and lane-compacted windows, and Byzantine sweeps."""
