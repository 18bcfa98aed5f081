from repro_torch.kernels.tree_route.ops import tree_route
from repro_torch.kernels.tree_route.ref import tree_route_ref

__all__ = ["tree_route", "tree_route_ref"]
