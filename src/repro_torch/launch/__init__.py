from repro_torch.launch.dist import Wire, spawn_ranks
from repro_torch.launch.mesh import (Mesh, dp_axes, make_debug_mesh,
                                     make_host_mesh, mesh_axes, pod_axis)

__all__ = ["Mesh", "Wire", "dp_axes", "make_debug_mesh", "make_host_mesh",
           "mesh_axes", "pod_axis", "spawn_ranks"]
