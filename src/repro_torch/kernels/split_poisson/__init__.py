from repro_torch.kernels.split_poisson.ops import split_poisson
from repro_torch.kernels.split_poisson.ref import split_poisson_ref

__all__ = ["split_poisson", "split_poisson_ref"]
