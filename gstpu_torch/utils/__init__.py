"""NumPy I/O (PLY checkpoints, cameras, images) and the program's spans and
counters (``tracing``)."""
