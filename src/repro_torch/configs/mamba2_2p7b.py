"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16,
)
