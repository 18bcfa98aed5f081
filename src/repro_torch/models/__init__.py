"""The LM zoo's dense and ssm families, for the port (``repro/models``)."""

from repro_torch.models.lm import LanguageModel, cache_defs, param_defs
from repro_torch.models.params import ParamDef, count_params, init_params

__all__ = ["LanguageModel", "ParamDef", "cache_defs", "count_params",
           "init_params", "param_defs"]
