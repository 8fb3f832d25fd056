"""The plain references that decide ``correct``.

Plain NumPy and PyTorch only: they import nothing of the port, of the JAX
package or of its benchmarks, and take nothing the program made.  They
work the answers out again from the inputs the benchmark drew.
"""
