"""Design-batch forward pipeline, geometry sweeps, the operations around
the solve and the multi-device layer (the names of
``raft_tpu.parallel``)."""
from raft_tpu_torch.parallel.multihost import (  # noqa: F401
    global_mesh,
    init_multihost,
    stage_global,
)
from raft_tpu_torch.parallel.geometry import (  # noqa: F401
    affine_warp,
    make_scale_plan,
    make_stretch_draft,
    substructure_masks,
)
from raft_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelineStats,
    dispatch_depth,
    donation_enabled,
    run_pipelined,
)
from raft_tpu_torch.parallel.optimize import (  # noqa: F401
    energy_sum,
    grad_nacelle_accel_std,
    nacelle_accel_std,
    optimize_design,
)
from raft_tpu_torch.parallel.sweep import (  # noqa: F401
    directional_response,
    forward_response,
    forward_response_dp_sp,
    forward_response_freq_sharded,
    grad_response_std,
    make_mesh,
    make_wave_states,
    mixed_sea_state,
    response_std,
    scale_diameters,
    spread_sea_state,
    stage_bem,
    sweep,
    sweep_designs,
    sweep_sea_states,
)
