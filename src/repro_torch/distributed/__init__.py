"""Distribution over ``torch.distributed``: sharding policy, placement,
gradient compression, pipeline, overlap, elastic remesh."""
from .sharding import (  # noqa: F401
    P, batch_pspecs, decode_state_pspecs, named, param_pspec, params_pspecs,
)
from .compress_grads import compressed_psum, init_error_state  # noqa: F401
from .elastic import HeartbeatMonitor, MeshPlan, plan_for_devices, reshard_tree  # noqa: F401
from .device_mesh import Mesh, make_mesh  # noqa: F401
