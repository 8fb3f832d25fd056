"""whisper-base — encoder-decoder; conv audio frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,              # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    gated_mlp=False,
    tie_embeddings=True,
    num_modality_tokens=1500,  # 30 s of audio at 50 frames/s (post-conv)
    modality_dim=80,           # mel bins -> stub projection to d_model
    source="arXiv:2212.04356; unverified",
)
