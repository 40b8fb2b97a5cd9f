"""Quasi-static mooring: catenary lines, equilibrium, stiffness."""
