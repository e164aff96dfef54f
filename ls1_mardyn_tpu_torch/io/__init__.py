"""I/O layer: phase-space reader/writer, XML config, generators."""
