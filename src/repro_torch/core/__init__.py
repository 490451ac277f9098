"""Numerics of the port: quantization, N:M pruning, sorted accumulation,
the accumulation policies and the integer dot (``dispatch.pqs_dot``)."""
