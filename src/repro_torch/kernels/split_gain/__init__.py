from repro_torch.kernels.split_gain.ops import split_gain
from repro_torch.kernels.split_gain.ref import split_gain_ref

__all__ = ["split_gain", "split_gain_ref"]
