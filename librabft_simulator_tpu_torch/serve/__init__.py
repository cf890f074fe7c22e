"""Fleets of heterogeneous scenarios: per-slot knob rows (``scenario``)."""
