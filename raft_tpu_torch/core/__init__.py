"""Core kernels and containers of the port."""
