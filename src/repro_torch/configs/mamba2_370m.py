"""mamba2-370m — attention-free SSM, SSD (state-space duality).
[arXiv:2405.21060] 48L d_model=1024, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, n_groups=1,
               conv_kernel=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
