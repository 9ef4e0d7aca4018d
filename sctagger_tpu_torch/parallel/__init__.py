"""Multi-device (mesh.py) and multi-host (multihost.py) execution."""

from .mesh import (  # noqa: F401
    STATS,
    Mesh,
    compute_devices,
    local_mesh,
    make_mesh,
    replicate,
    shard_adapter_scan,
    shard_hw_block,
    shard_match_full,
    shard_match_full_mp,
    shard_match_min,
    shard_probe,
)
from .multihost import (  # noqa: F401
    HostGroup,
    close_gloo,
    gloo_processes_match,
    init_gloo,
    make_host_group,
)
