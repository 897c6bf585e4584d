"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings.  [arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,        # decoder layers
    n_enc_layers=24,    # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    mlp_gated=False,
    activation="gelu",
    enc_len=4096,       # stub frontend memory length for decode shapes
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, enc_len=32,
)
