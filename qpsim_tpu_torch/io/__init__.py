"""Host-side input/output: the precompute payload of gap maps."""
