"""llama-3.2-vision-90b — VLM with cross-attention image layers; vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; cross-attn every
5th layer (20 cross + 80 self).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    cross_attn_every=5,
    num_modality_tokens=1601,  # 1 tile x (40x40 patches + cls)
    modality_dim=1280,         # ViT-H width -> stub projection
    optimizer="adafactor",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
