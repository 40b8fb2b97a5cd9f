"""Design-batch forward pipeline and geometry sweeps."""
