from repro_torch.kernels.vht_stats.ops import stats_update
from repro_torch.kernels.vht_stats.ref import stats_update_ref

__all__ = ["stats_update", "stats_update_ref"]
