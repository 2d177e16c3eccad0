"""The benchmark's harness: manifest, traffic, the worker loop, tracing,
the roofline's prices and the correctness check."""
