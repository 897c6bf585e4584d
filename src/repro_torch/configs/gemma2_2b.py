"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating (1:1, window 4096), attn logit
softcap 50, final logit softcap 30, sandwich norms.  [arXiv:2408.00118; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    mlp_gated=True,
    activation="gelu",
    sliding_window=4096,
    local_period=2,       # alternating local / global
    local_count=1,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norm=True,
    emb_scale_by_sqrt_dim=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, sliding_window=8,
)
