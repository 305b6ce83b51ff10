from repro_torch.launch.mesh import (Mesh, dp_axes, make_debug_mesh,
                                     make_host_mesh, pod_axis)

__all__ = ["Mesh", "dp_axes", "make_debug_mesh", "make_host_mesh",
           "pod_axis"]
