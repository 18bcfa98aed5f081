"""qwen1.5-4b [dense]: MHA with QKV bias.

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936
[hf:Qwen/Qwen1.5-4B family; hf]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen15_4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-4B",
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
)
