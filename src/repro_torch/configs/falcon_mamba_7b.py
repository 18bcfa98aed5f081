"""falcon-mamba-7b [ssm]: attention-free mamba-1 stack.

64L d_model=4096, ssm_state=16, expand=2, conv=4, vocab=65024
[arXiv:2410.05355; unverified]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    attn_type="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2410.05355",
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=64,
    vocab_size=512,
    ssm_chunk=16,
)
