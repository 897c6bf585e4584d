"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 backbone + ONE shared attention+MLP
block applied every 6th layer.  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_period=6,
    mlp_gated=True,
    activation="gelu",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, hybrid_period=3,
    ssm_chunk=16,
)
