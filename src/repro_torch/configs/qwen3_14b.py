"""qwen3-14b [dense]: 40 layers, d_model 5120, 40 query heads (GQA, 8 KV
heads), head_dim 128, d_ff 17408, vocab 151936, qk-norm, untied head.  The
numbers are a copy of the reference config (Qwen3 family, published
widths); ``mechanism="sla2"`` serves it with SLA2 decode."""
from repro_torch.models.transformer import ModelConfig


def config(**overrides):
    """Full-size config (published widths and depth)."""
    kw = dict(
        name="qwen3_14b",
        n_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False,
        mechanism="sla2", max_target_len=524288,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config(**overrides):
    """Reduced same-family config for CPU tests."""
    kw = dict(
        name="qwen3_14b_smoke",
        n_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, qk_norm=True, tie_embeddings=False,
        mechanism="sla2", block_q=32, block_k=16, k_frac=0.25,
        max_target_len=512, loss_chunk=64, dtype="float32", q_chunk=4,
    )
    kw.update(overrides)
    return ModelConfig(**kw)
