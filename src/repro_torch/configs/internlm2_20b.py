"""internlm2-20b [dense]: 48 layers, d_model 6144, 48 query heads (GQA, 8
KV heads: 6 query heads a KV head), head_dim 128, d_ff 16384, vocab 92544,
no qk-norm, untied head.  The numbers are a copy of the reference config
(arXiv:2403.17297, published widths); ``mechanism="sla2"`` serves it with
SLA2 decode."""
from repro_torch.models.transformer import ModelConfig


def config(**overrides):
    """Full-size config (published widths and depth)."""
    kw = dict(
        name="internlm2_20b",
        n_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92544,
        rope_theta=1_000_000.0, tie_embeddings=False,
        mechanism="sla2", max_target_len=524288,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config(**overrides):
    """Reduced same-family config for CPU tests."""
    kw = dict(
        name="internlm2_20b_smoke",
        n_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, tie_embeddings=False,
        mechanism="sla2", block_q=32, block_k=16, k_frac=0.25,
        max_target_len=512, loss_chunk=64, dtype="float32", q_chunk=4,
    )
    kw.update(overrides)
    return ModelConfig(**kw)
