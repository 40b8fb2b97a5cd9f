"""Physical constants and environment defaults (copy of ``raft_tpu.core.constants``)."""

RHO_SEAWATER = 1025.0   # [kg/m^3] default water density
GRAVITY = 9.81          # [m/s^2]  gravitational acceleration

DEFAULT_HS = 1.0        # [m]   significant wave height
DEFAULT_TP = 10.0       # [s]   peak spectral period
DEFAULT_V = 10.0        # [m/s] mean wind speed
DEFAULT_BETA = 0.0      # [rad] wave heading
