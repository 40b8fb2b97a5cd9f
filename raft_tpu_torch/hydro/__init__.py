"""Strip-theory (Morison) hydrodynamics."""
