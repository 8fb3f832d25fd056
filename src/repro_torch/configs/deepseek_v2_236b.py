"""deepseek-v2-236b — MoE 160e top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff=1536 (per routed expert)
vocab=102400; first layer dense; MLA q_lora=1536, nope/rope 128/64, v=128.
"""
from repro_torch.configs.base import ModelConfig, MoECfg, MLACfg

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: all heads share the compressed latent
    d_ff=12288,                # dense FFN width (layer 0)
    vocab_size=102400,
    head_dim=128,
    moe=MoECfg(num_experts=160, top_k=6, d_ff=1536,
               num_shared=2, shared_d_ff=1536, period=1, first_dense=1),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    optimizer="adafactor",
    source="arXiv:2405.04434; hf",
)
