"""Plain PyTorch and NumPy reference of the benchmark's cells; imports nothing of the program."""
