from repro_torch.kernels.rule_stats.ops import (batch_sum, rule_moments,
                                                rule_stats_scatter,
                                                rule_stats_update,
                                                segment_sum)
from repro_torch.kernels.rule_stats.ref import (rule_stats_ref,
                                                rule_stats_scatter_ref)

__all__ = ["batch_sum", "rule_moments", "rule_stats_ref",
           "rule_stats_scatter", "rule_stats_scatter_ref",
           "rule_stats_update", "segment_sum"]
