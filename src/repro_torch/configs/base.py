"""Architecture and shape configuration of the LM zoo, for the port.

A copy of the JAX package's ``configs/base.py``: ``ModelConfig`` keeps every
field, with the same defaults, so that a configuration reads alike in both
packages; the port reads only those its ported families use.  Fields of
the TPU's schedule (``attn_q_chunk``, ``attn_kv_chunk``, ``attn_schedule``,
``attn_probs_bf16``, ``remat``, ``seq_parallel``, ``use_pallas``,
``ssm_chunk``) have no effect here: the port's full-sequence forward
always runs its CUDA kernels (or, on CPU tensors, their plain versions)
over the whole sequence.

``ARCHS`` lists the architectures the port runs; ``get_config`` of any
other raises a ``KeyError`` that names them.
"""

from __future__ import annotations

import dataclasses
import importlib


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention flavour
    attn_type: str = "gqa"          # gqa | mla | none
    qkv_bias: bool = False
    window: int = 0                 # >0 -> local (sliding window) attention
    rope_theta: float = 10_000.0

    # MLA (deepseek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_dispatch: str = "einsum"
    ep_over_dp: bool = False

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model/16)
    ssm_chunk: int = 128

    # hybrid block pattern (recurrentgemma): repeated unit + tail
    block_pattern: tuple[str, ...] = ()
    d_rnn: int = 0                  # RG-LRU width (0 -> d_model)

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 4

    # modality frontend stub
    frontend: str = "none"          # none | patch_stub | frames_stub
    n_frontend_tokens: int = 0

    # norms / activations / embeddings
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | relu2 | gelu
    tie_embeddings: bool = False
    learned_pos_emb: bool = False

    # numerics & schedule (the TPU's; see the module docstring)
    dtype: str = "bfloat16"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_schedule: str = "scan"
    attn_probs_bf16: bool = False
    virtual_head_pad: int = 0
    remat: str = "layer"
    seq_parallel: bool = False
    use_pallas: bool = False

    # citation / provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_state and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))
        if self.block_pattern and not self.d_rnn:
            object.__setattr__(self, "d_rnn", self.d_model)

    # the vocabulary padded to a multiple of 512, as the JAX package pads it
    # for sharding; the true vocabulary is masked in the logits
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 512)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def heads_padded(self) -> int:
        if not self.virtual_head_pad:
            return self.n_heads
        return _round_up(self.n_heads, self.virtual_head_pad)

    @property
    def kv_heads_padded(self) -> int:
        if not self.virtual_head_pad:
            return self.n_kv_heads
        return _round_up(self.n_kv_heads, self.virtual_head_pad)

    def n_params(self) -> int:
        from repro_torch.models.lm import param_defs
        from repro_torch.models.params import count_params
        return count_params(param_defs(self))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# the architectures whose families the port runs (ssm and dense)
ARCHS = (
    "qwen15_4b",
    "falcon_mamba_7b",
)


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; the port runs {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg: ModelConfig = _module(arch).CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    """The reduced same-family config of the CPU tests."""
    return _module(arch).SMOKE
