"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Attention layer once per 8 layers; MoE every 2nd layer (AI21 Jamba layout).
"""
from repro_torch.configs.base import ModelConfig, MoECfg, SSMCfg

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,
    moe=MoECfg(num_experts=16, top_k=2, d_ff=24576, period=2),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1,
               conv_kernel=4, chunk=256),
    optimizer="adafactor",
    source="arXiv:2403.19887; hf",
)
