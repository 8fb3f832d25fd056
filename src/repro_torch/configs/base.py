"""Config dataclasses for model architectures and input shapes (a copy of
``repro.configs.base``).

Every assigned architecture gets one module in this package exporting CONFIG.
The CPU tests use `reduce_config` to build a tiny same-family twin; the card
runs the full configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden width
    num_shared: int = 0         # always-on shared experts
    shared_d_ff: int = 0        # hidden width of each shared expert
    period: int = 1             # every `period`-th layer is MoE (1 = all MoE)
    first_dense: int = 0        # first `first_dense` layers use a dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (jamba): one attention layer per `attn_every` layers, rest SSM.
    attn_every: int = 0
    # vlm: one cross-attention layer per `cross_attn_every` layers.
    cross_attn_every: int = 0
    # encdec: number of encoder layers (num_layers = decoder layers then).
    encoder_layers: int = 0
    # modality stub frontend: precomputed embeddings fed to the backbone.
    num_modality_tokens: int = 0
    modality_dim: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    gated_mlp: bool = True      # SwiGLU (3 mats) vs classic GELU MLP (2 mats)
    tie_embeddings: bool = False
    optimizer: str = "adamw"    # adamw | adafactor (big archs)
    # citation tag from the assignment table
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_path(self) -> bool:
        """long_500k eligibility: SSM / hybrid archs only (per assignment)."""
        return self.family in ("ssm", "hybrid")

    def moe_layer_ids(self) -> list[int]:
        if self.moe is None:
            return []
        m = self.moe
        return [i for i in range(self.num_layers)
                if i >= m.first_dense and (i + 1) % m.period == 0]

    def attn_layer_ids(self) -> list[int]:
        if self.family == "hybrid":
            # jamba: 1 attention per `attn_every` layers, placed last in group.
            return [i for i in range(self.num_layers)
                    if (i + 1) % self.attn_every == 0]
        if self.family == "ssm":
            return []
        return list(range(self.num_layers))

    # ---------------- parameter counting (for MODEL_FLOPS) ----------------

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            h = self.num_heads
            q = d * m.q_lora_rank + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            o = h * m.v_head_dim * d
            return q + kv + o
        qo = 2 * d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        return qo + kv

    def _ffn_params(self, layer: int) -> int:
        d = self.d_model
        if self.moe is not None and layer in set(self.moe_layer_ids()):
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff
            shared = m.num_shared * 3 * d * (m.shared_d_ff or m.d_ff)
            router = d * m.num_experts
            return routed + shared + router
        return (3 if self.gated_mlp else 2) * d * self.d_ff

    def _ffn_active_params(self, layer: int) -> int:
        d = self.d_model
        if self.moe is not None and layer in set(self.moe_layer_ids()):
            m = self.moe
            routed = m.top_k * 3 * d * m.d_ff
            shared = m.num_shared * 3 * d * (m.shared_d_ff or m.d_ff)
            return routed + shared + d * m.num_experts
        return (3 if self.gated_mlp else 2) * d * self.d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
        conv = conv_dim * s.conv_kernel
        out = d_in * d
        extra = 3 * nheads + d_in  # A, D, dt_bias, norm
        return in_proj + conv + out + extra

    def param_counts(self) -> tuple[int, int]:
        """(total_params, active_params_per_token) — embeddings included once."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        attn_ids = set(self.attn_layer_ids())
        cross_ids = set()
        if self.family == "vlm" and self.cross_attn_every:
            cross_ids = {i for i in range(self.num_layers)
                         if (i + 1) % self.cross_attn_every == 0}
        n_backbone = self.num_layers + self.encoder_layers
        for i in range(n_backbone):
            li = i if i < self.num_layers else i - self.num_layers
            if self.family in ("ssm", "hybrid") and li not in attn_ids and i < self.num_layers:
                blk = self._ssm_params()
                f = self._ffn_params(li) if self.moe else 0
                fa = self._ffn_active_params(li) if self.moe else 0
                total += blk + f + 2 * d
                active += blk + fa + 2 * d
                continue
            a = self._attn_params()
            f = self._ffn_params(li)
            fa = self._ffn_active_params(li)
            cross = self._attn_params() if li in cross_ids else 0
            total += a + f + cross + 3 * d
            active += a + fa + cross + 3 * d
        if self.modality_dim:
            total += self.modality_dim * d
            active += self.modality_dim * d
        return total, active


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCfg] = {
    "train_4k":    ShapeCfg("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeCfg("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeCfg("long_500k",   524_288, 1,   "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Return (runnable, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_path:
        return False, ("pure full-attention arch: 512K-token decode requires a "
                       "sub-quadratic path (assignment: run long_500k only for "
                       "SSM/hybrid/linear-attn)")
    return True, ""


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family twin for CPU smoke tests (shapes asserted, no NaNs)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=4 if cfg.family in ("hybrid",) else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64,
            shared_d_ff=64 if cfg.moe.num_shared else 0,
            first_dense=min(cfg.moe.first_dense, 1))
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, q_lora_rank=48,
                           qk_nope_head_dim=16, qk_rope_head_dim=8,
                           v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, head_dim=16, expand=2, n_groups=1,
                           conv_kernel=4, chunk=32)
    if cfg.family == "hybrid":
        kw["attn_every"] = 2
    if cfg.family == "vlm":
        kw["cross_attn_every"] = 2
        kw["num_modality_tokens"] = 8
        kw["modality_dim"] = 32
    if cfg.family == "encdec":
        kw["encoder_layers"] = 2
        kw["num_modality_tokens"] = 16
        kw["modality_dim"] = 32
    return dataclasses.replace(cfg, **kw)
