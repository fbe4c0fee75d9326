"""llama4-maverick-400b-a17b [moe]: 48 layers, d_model 5120, 40 query
heads (GQA, 8 KV heads: 5 query heads a KV head), head_dim 128, d_ff 8192,
vocab 202048; dense and MoE layers interleaved (``layer_kinds=("dense",
"moe")``), 128 routed experts at top-1 (d_ff_expert 8192) plus one
always-on shared expert, capacity factor 1.25; untied head, rope 5e5.
The numbers are a copy of the reference config (hf:meta-llama/Llama-4
family, the text path).  Two of the reference's fields are left out: the
port's ModelConfig has no ``family`` (read only for VLMs) and no
``ep_axis`` (read only under a mesh, which is not ported yet)."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def config(**overrides):
    """Full-size config (published widths and depth)."""
    kw = dict(
        name="llama4_maverick_400b",
        n_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        layer_kinds=("dense", "moe"),
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                      num_shared=1, capacity_factor=1.25),
        rope_theta=500_000.0, tie_embeddings=False,
        mechanism="sla2", max_target_len=524288,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config(**overrides):
    """Reduced same-family config for CPU tests."""
    kw = dict(
        name="llama4_maverick_smoke",
        n_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, layer_kinds=("dense", "moe"),
        moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=64, num_shared=1),
        tie_embeddings=False, mechanism="sla2", block_q=32, block_k=16,
        k_frac=0.25, max_target_len=512, loss_chunk=64, dtype="float32",
        q_chunk=4,
    )
    kw.update(overrides)
    return ModelConfig(**kw)
