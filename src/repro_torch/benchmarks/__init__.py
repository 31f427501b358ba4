"""Benchmarks of the port: ``kernel_bench`` (each kernel at the reference
bench's shapes) and ``roofline`` (the H100 bound of each kernel's work)."""
