"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local:global (window 1024), QK-norm, 128k context.
[hf:google/gemma-3-4b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    mlp_gated=True,
    activation="gelu",
    sliding_window=1024,
    local_period=6,        # 5 local : 1 global
    local_count=5,
    qk_norm=True,
    post_norm=True,
    emb_scale_by_sqrt_dim=True,
    rope_theta=1_000_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, sliding_window=8,
)
