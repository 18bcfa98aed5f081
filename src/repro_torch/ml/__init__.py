from repro_torch.ml.htree import (TreeConfig, init_tree, route, split_gains,
                                  update_stats)
from repro_torch.ml.vht import VHT, VHTConfig, ShardingEnsemble
from repro_torch.ml.amrules import AMRules, HAMR, RulesConfig, VAMR
from repro_torch.ml.clustream import CluStream, CluStreamConfig
from repro_torch.ml.ensemble import EnsembleConfig, OzaEnsemble
from repro_torch.ml.fleet import FLEET_FAMILIES, LearnerFleet, stack_payloads

__all__ = [
    "TreeConfig", "init_tree", "route", "update_stats", "split_gains",
    "VHT", "VHTConfig", "ShardingEnsemble",
    "AMRules", "HAMR", "RulesConfig", "VAMR",
    "CluStream", "CluStreamConfig",
    "EnsembleConfig", "OzaEnsemble",
    "FLEET_FAMILIES", "LearnerFleet", "stack_payloads",
]
