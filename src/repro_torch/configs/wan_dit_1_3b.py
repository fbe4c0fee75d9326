"""wan-dit-1.3b: the paper's own target, a Wan2.1-1.3B-480P-like video DiT
with bidirectional SLA2 self-attention, text cross-attention, adaLN-zero
conditioning and a rectified-flow objective.  At 480P x 5s the video latent
is about 32k tokens.  The numbers are a copy of the reference config."""
from repro_torch.models.dit import DiTConfig

DIT_SHAPES = {
    "train_32k": {"seq_len": 32768, "global_batch": 64, "mode": "train"},
    "denoise_32k": {"seq_len": 32768, "global_batch": 8, "mode": "prefill"},
}


def config(**overrides):
    """Full-size config (published widths)."""
    kw = dict(
        name="wan_dit_1_3b",
        n_layers=30, d_model=1536, num_heads=12, head_dim=128, d_ff=8960,
        c_latent=16, n_text=77, mechanism="sla2",
        block_q=128, block_k=64, k_frac=0.05, quant_bits="int8",
        max_target_len=32768,
    )
    kw.update(overrides)
    return DiTConfig(**kw)


def smoke_config(**overrides):
    """Reduced same-family config for CPU tests."""
    kw = dict(
        name="wan_dit_smoke",
        n_layers=2, d_model=64, num_heads=2, head_dim=32, d_ff=128,
        c_latent=8, n_text=16, mechanism="sla2", block_q=32, block_k=16,
        k_frac=0.25, dtype="float32", max_target_len=256, q_chunk=2,
    )
    kw.update(overrides)
    return DiTConfig(**kw)
