"""The plain references the benchmark holds the port to (plain float32
PyTorch, nothing of the port), and the comparisons that decide
``correct``."""
