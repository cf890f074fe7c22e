"""Post-run analysis: the data writer and the BASELINE sweeps."""
