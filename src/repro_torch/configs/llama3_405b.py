"""llama3-405b [dense]: 126 layers, d_model 16384, 128 query heads (GQA,
8 KV heads: 16 query heads a KV head, the largest ratio the paged kernels
take), head_dim 128, d_ff 53248, vocab 128256, untied head, rope 5e5.  The
numbers are a copy of the reference config (arXiv:2407.21783, published
widths); the port's ModelConfig has no ``family`` field (read only for
VLMs)."""
from repro_torch.models.transformer import ModelConfig


def config(**overrides):
    """Full-size config (published widths and depth)."""
    kw = dict(
        name="llama3_405b",
        n_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        head_dim=128, d_ff=53248, vocab_size=128256,
        rope_theta=500_000.0, tie_embeddings=False,
        mechanism="sla2", max_target_len=524288,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config(**overrides):
    """Reduced same-family config for CPU tests."""
    kw = dict(
        name="llama3_405b_smoke",
        n_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=256, tie_embeddings=False,
        mechanism="sla2", block_q=32, block_k=16, k_frac=0.25,
        max_target_len=512, loss_chunk=64, dtype="float32", q_chunk=4,
    )
    kw.update(overrides)
    return ModelConfig(**kw)
