"""llama4-maverick-400b-a17b — MoE 128e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048. MoE every 2nd layer
(Maverick interleaves dense/MoE); shared expert always on.
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,            # dense (non-MoE) layers
    vocab_size=202048,
    head_dim=128,
    rope_theta=5e5,
    moe=MoECfg(num_experts=128, top_k=1, d_ff=8192,
               num_shared=1, shared_d_ff=8192, period=2),
    optimizer="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
