"""Host-side input/output: files, frame streams, checkpoints and precompute payloads."""
